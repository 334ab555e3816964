"""The §IV.B.2 multi-containment window query: the earliest feasible start
on each device, ``found`` and ``start``.

The kernels' wrapper is ``window_query.window_query(_batched)`` (the
module keeps the launch counts); the package exports the dispatchers and
the plain versions.
"""

from repro_torch.kernels.window_query.ops import (
    window_query_batched_op, window_query_op,
)
from repro_torch.kernels.window_query.ref import (
    window_query_batched_ref, window_query_ref,
)

__all__ = ["window_query_batched_op", "window_query_batched_ref",
           "window_query_op", "window_query_ref"]
