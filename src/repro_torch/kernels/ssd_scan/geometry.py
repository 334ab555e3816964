"""Launch geometry of the SSD scan kernel (``csrc/ssd_scan.cu``), for
``analysis/launch_check.py``.

One block per (head, batch row): grid ``launch_grid(B, H)`` in (x, y)
order. A block reads its head of x, dt and A and the row's B and C over the
whole sequence, and writes its head of y. The chunks are a loop inside the
block, not a grid axis; the grid has no ragged edge.
"""

from __future__ import annotations

from repro_torch.analysis.launch_check import (
    BlockDecl, KernelGeometry, register,
)
from repro_torch.kernels.ssd_scan.ssd_scan import launch_grid

_MODULE = "repro_torch.kernels.ssd_scan.ssd_scan"


def _case(B, S, H, P, N):
    row = lambda name: BlockDecl(name, (B, S, N), (1, S, N),
                                 lambda h, b: (b, 0, 0))
    head = lambda name: BlockDecl(name, (B, S, H, P), (1, S, 1, P),
                                  lambda h, b: (b, 0, h, 0))
    return KernelGeometry(
        kernel="ssd_scan", module=_MODULE, case=f"B{B}S{S}H{H}P{P}N{N}",
        grid=launch_grid(B, H),
        inputs=(head("x"),
                BlockDecl("dt", (B, S, H), (1, S, 1), lambda h, b: (b, 0, h)),
                BlockDecl("A", (H,), (1,), lambda h, b: (h,)),
                row("B"), row("C")),
        outputs=(head("y"),),
    )


@register("ssd_scan")
def geometries():
    # zamba2-7b's layer and chip_smoke.py's ragged case
    return [_case(1, 4096, 112, 64, 64), _case(2, 77, 3, 64, 64)]
