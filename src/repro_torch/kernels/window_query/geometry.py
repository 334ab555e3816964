"""Launch geometry of the window-query kernels (``csrc/window_query.cu``),
for ``analysis/launch_check.py``.

Both launches flatten the (replica, device) rows: a block takes one
contiguous tile of ``rows_per_block(T·W)`` rows (8 warps of 32 / G rows,
G = ``group_size(T·W)`` lanes a row), a grid of ``launch_grid(B·Dev,
T·W)`` blocks, the same for both routes. So the windows are declared as
[B·Dev, T·W] in tiles of that many rows, and the parameters and outputs
as [B·Dev] in tiles of the same rows. The Pallas
version padded the device axis to a whole block; the CUDA kernel masks its
own row edge, so the row dim is a masked dim instead. Every block writes
only the rows of its own tile.
"""

from __future__ import annotations

from repro_torch.analysis.launch_check import (
    BlockDecl, KernelGeometry, register,
)
from repro_torch.kernels.window_query.window_query import (
    launch_grid, rows_per_block,
)

_MODULE = "repro_torch.kernels.window_query.window_query"


def _case(kernel: str, case: str, rows: int, tw: int, params: tuple):
    masked = frozenset({0})
    tile = rows_per_block(tw)
    win = lambda name: BlockDecl(name, (rows, tw), (tile, tw),
                                 lambda i: (i, 0), masked_dims=masked)
    row = lambda name: BlockDecl(name, (rows,), (tile,),
                                 lambda i: (i,), masked_dims=masked)
    return KernelGeometry(
        kernel=kernel, module=_MODULE, case=case, grid=launch_grid(rows, tw),
        inputs=(*map(win, ("t1", "t2", "valid")), *map(row, params)),
        outputs=(row("start"), row("found")),
    )


def _unbatched(Dev, T, W):
    return _case("window_query", f"Dev{Dev}T{T}W{W}", Dev, T * W, ())


def _batched(B, Dev, T, W):
    return _case("window_query_batched", f"B{B}Dev{Dev}T{T}W{W}", B * Dev,
                 T * W, ("q1", "deadline", "dur"))


@register("window_query")
def geometries():
    return [
        # the paper testbed, the reference's padded case and test sweeps
        _unbatched(4, 2, 16), _unbatched(6, 2, 16), _unbatched(4, 2, 8),
        _unbatched(64, 3, 16), _unbatched(300, 2, 32),
        # chip_smoke.py: bench_query's 1024 devices, the ragged 300, the
        # large case and T 1 x W 15 (the scalar route)
        _unbatched(1024, 2, 64), _unbatched(300, 2, 16),
        _unbatched(262_144, 2, 16), _unbatched(4096, 1, 15),
        # the reference's cases, the fleet tests' HP view (B=17, one
        # device), a list of 3 tracks, and chip_smoke.py's batches: B 8192
        # x 4, the fleet's HP view, B 3 x 6 and the view offset by one
        # element (the scalar route)
        _batched(8, 4, 2, 16), _batched(3, 6, 2, 16), _batched(17, 1, 2, 16),
        _batched(5, 3, 3, 16),
        _batched(8192, 4, 2, 16), _batched(8192, 1, 2, 16),
        _batched(2048, 4, 2, 16),
    ]
