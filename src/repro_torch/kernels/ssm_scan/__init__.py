"""Mamba-1 selective scan: ``h = exp(dt·A) h + dt·u·B``, ``y = C·h``.

The kernel's wrapper is ``ssm_scan.ssm_scan`` (the module keeps the launch
count); the package exports the dispatcher and the plain version.
"""

from repro_torch.kernels.ssm_scan.ops import ssm_scan_op
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

__all__ = ["ssm_scan_op", "ssm_scan_ref"]
