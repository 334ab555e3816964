"""Dispatching wrappers for the window query — the single source of the
backend policy; the fleet engine's HP query goes through
``window_query_batched_op``.

Unlike the JAX package's dispatchers, there is no padding of the device
axis: the CUDA kernels mask their own row edge.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.window_query.ref import (
    window_query_batched_ref, window_query_ref,
)
from repro_torch.kernels.window_query.window_query import (
    window_query, window_query_batched,
)


def _backend(backend: str, t1) -> str:
    if backend == "auto":
        return "kernel" if t1.is_cuda else "ref"
    if backend not in ("kernel", "ref"):
        raise ValueError(f"unknown window-query backend: {backend!r}")
    return backend


def window_query_op(t1, t2, valid, q1, deadline, dur, *,
                    backend: str = "auto"):
    """t1, t2, valid: [Dev,T,W]; q1, deadline, dur: Python numbers
    -> (found [Dev] i32, start [Dev] f32).

    backend: "auto" -> the CUDA kernel for CUDA tensors, the plain PyTorch
    version for CPU tensors; "kernel" -> the CUDA kernel (raises on CPU
    tensors: there is no interpret mode); "ref" -> the plain version on any
    device. A kernel that fails to build or launch raises; nothing falls
    back to the plain version.

    Launches are counted in ``window_query.launches``.
    """
    if _backend(backend, t1) == "kernel":
        return window_query(t1, t2, valid.bool(), q1, deadline, dur)
    return window_query_ref(t1, t2, valid, q1, deadline, dur)


def window_query_batched_op(t1, t2, valid, q1, deadline, dur, *,
                            backend: str = "auto"):
    """t1, t2, valid: [B,Dev,T,W] (views whose [T, W] blocks are
    contiguous are read in place); q1, deadline, dur: scalars or tensors
    broadcastable to [B,Dev] -> (found [B,Dev] i32, start [B,Dev] f32).

    backend: as for ``window_query_op``. Launches are counted in
    ``window_query.launches_batched``.
    """
    if _backend(backend, t1) == "ref":
        return window_query_batched_ref(t1, t2, valid, q1, deadline, dur)
    B, Dev = t1.shape[:2]
    q1, deadline, dur = (_param(x, (B, Dev), t1.device)
                         for x in (q1, deadline, dur))
    return window_query_batched(t1, t2, valid.bool(), q1, deadline, dur)


def _param(x, shape, device):
    """A query parameter as an f32 tensor of ``shape`` on ``device``: one
    that is already that is passed as it is (the fleet's [B, 1] columns),
    anything else broadcast to it."""
    if (isinstance(x, torch.Tensor) and x.dtype == torch.float32
            and x.device == device and x.shape == shape):
        return x
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(
        shape)
