"""Fused §IV.B.2 placement (query + select + fan-out commit in one launch)
and the fleet's HP fan-out commit, one launch each."""

from repro_torch.kernels.placement.ops import fanout_commit_op, fused_place_op
from repro_torch.kernels.placement.placement import fanout_commit, fused_place
from repro_torch.kernels.placement.ref import fused_place_ref

__all__ = ["fanout_commit", "fanout_commit_op", "fused_place",
           "fused_place_op", "fused_place_ref"]
