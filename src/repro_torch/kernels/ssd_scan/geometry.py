"""Launch geometry of the SSD scan kernel (``csrc/ssd_scan.cu``), for
``analysis/launch_check.py``.

One block per (``BLOCK_P`` columns of the head dim, head, batch row): grid
``launch_grid(B, H, P)`` in (x, y, z) order, on both routes (bf16 on the
tensor cores, f32 on the CUDA cores). A block reads its columns of x over
the whole sequence, its head of dt and A and the row's B and C, and writes
its columns of y. The chunks are a loop inside the block, not a grid axis;
the grid has no ragged edge.
"""

from __future__ import annotations

from repro_torch.analysis.launch_check import (
    BlockDecl, KernelGeometry, register,
)
from repro_torch.kernels.ssd_scan.ssd_scan import BLOCK_P, launch_grid

_MODULE = "repro_torch.kernels.ssd_scan.ssd_scan"


def _case(B, S, H, P, N, G=0):
    """G 0: B and C [B,S,N]; G >= 1: [B,S,G,N], head h reading group
    h // (H // G)."""
    if G:
        row = lambda name: BlockDecl(name, (B, S, G, N), (1, S, 1, N),
                                     lambda pb, h, b: (b, 0, h // (H // G),
                                                       0))
    else:
        row = lambda name: BlockDecl(name, (B, S, N), (1, S, N),
                                     lambda pb, h, b: (b, 0, 0))
    cols = lambda name: BlockDecl(name, (B, S, H, P), (1, S, 1, BLOCK_P),
                                  lambda pb, h, b: (b, 0, h, pb))
    return KernelGeometry(
        kernel="ssd_scan", module=_MODULE,
        case=f"B{B}S{S}H{H}P{P}N{N}" + (f"G{G}" if G else ""),
        grid=launch_grid(B, H, P),
        inputs=(cols("x"),
                BlockDecl("dt", (B, S, H), (1, S, 1),
                          lambda pb, h, b: (b, 0, h)),
                BlockDecl("A", (H,), (1,), lambda pb, h, b: (h,)),
                row("B"), row("C")),
        outputs=(cols("y"),),
    )


@register("ssd_scan")
def geometries():
    # zamba2-7b's layer and chip_smoke.py's ragged case; zamba2-7b-instruct's
    # two state groups at the prefill cell's longest and shortest steps, and
    # chip_smoke.py's ragged case in three groups
    return [_case(1, 4096, 112, 64, 64), _case(2, 77, 3, 64, 64),
            _case(4, 4096, 112, 64, 64, 2), _case(64, 256, 112, 64, 64, 2),
            _case(2, 77, 6, 64, 64, 3)]
