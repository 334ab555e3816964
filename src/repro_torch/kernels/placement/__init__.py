"""Fused §IV.B.2 placement: query + select + fan-out commit in one launch."""

from repro_torch.kernels.placement.ops import fused_place_op
from repro_torch.kernels.placement.placement import fused_place
from repro_torch.kernels.placement.ref import fused_place_ref

__all__ = ["fused_place", "fused_place_op", "fused_place_ref"]
