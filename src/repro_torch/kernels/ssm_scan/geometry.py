"""Launch geometry of the selective-scan kernel (``csrc/ssm_scan.cu``), for
``analysis/launch_check.py``.

One block per (``BLOCK_D`` channels, batch row): grid
``launch_grid(B, di)`` in (x, y) order, ``LANES`` threads a channel. A
block reads its channels of u and dt over the whole sequence, their rows
of A and the row's B and C, and writes its channels of y; the ragged last
channel block is masked in the kernel. The sequence is a loop inside the
block, not a grid axis.
"""

from __future__ import annotations

from repro_torch.analysis.launch_check import (
    BlockDecl, KernelGeometry, register,
)
from repro_torch.kernels.ssm_scan.ssm_scan import BLOCK_D, launch_grid

_MODULE = "repro_torch.kernels.ssm_scan.ssm_scan"


def _case(B, S, di, N):
    masked = frozenset({2})
    chans = lambda name: BlockDecl(name, (B, S, di), (1, S, BLOCK_D),
                                   lambda i, b: (b, 0, i), masked_dims=masked)
    row = lambda name: BlockDecl(name, (B, S, N), (1, S, N),
                                 lambda i, b: (b, 0, 0))
    return KernelGeometry(
        kernel="ssm_scan", module=_MODULE, case=f"B{B}S{S}di{di}N{N}",
        grid=launch_grid(B, di),
        inputs=(chans("u"), chans("dt"),
                BlockDecl("A", (di, N), (BLOCK_D, N), lambda i, b: (i, 0),
                          masked_dims=frozenset({0})),
                row("B"), row("C")),
        outputs=(chans("y"),),
    )


@register("ssm_scan")
def geometries():
    # falcon-mamba-7b's layer, chip_smoke.py's ragged case and a test case
    return [_case(1, 4096, 8192, 16), _case(2, 77, 200, 16),
            _case(2, 128, 128, 16)]
