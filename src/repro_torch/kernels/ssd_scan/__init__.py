"""Mamba-2 SSD scan: ``h = exp(dt·A) h + dt·B xᵀ``, ``y = C·h``, one scalar
decay per head.

The kernel's wrapper is ``ssd_scan.ssd_scan`` (the module keeps the launch
count); the package exports the dispatcher and the plain version.
"""

from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

__all__ = ["ssd_scan_op", "ssd_scan_ref"]
