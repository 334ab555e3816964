"""Dispatching wrapper for the selective scan — the single source of the
backend policy; ``models/ssm.py::mamba1_forward`` sends every scan of a CUDA
tensor through here.

Unlike the JAX package's dispatcher, there is no fallback for a sequence
or channel count that is not a multiple of the block: the CUDA kernel masks
its own ragged edges.

The kernel route is differentiable: ``_KernelSSM`` runs the CUDA kernel
forward and, in the backward, recomputes ``ssm_scan_ref`` (the path the
port's CPU forward takes) on the saved inputs and takes its vjp
(``kernels/_autograd.py``).
"""

from __future__ import annotations

import torch

from repro_torch import spmd
from repro_torch.kernels._autograd import recompute_vjp
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.ssm_scan.ssm_scan import ssm_scan


class _KernelSSM(torch.autograd.Function):
    """The CUDA kernel forward; the backward is the vjp of
    ``ssm_scan_ref`` recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C):
        ctx.save_for_backward(u, dt, A, B, C)
        return ssm_scan(u, dt, A, B, C)

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_vjp(ssm_scan_ref, ctx, grad_out)


def ssm_scan_op(u, dt, A, B, C, *, backend: str = "auto"):
    """u, dt: [B,S,di]; A: [di,N]; B, C: [B,S,N] -> y [B,S,di].

    backend: "auto" -> the CUDA kernel for CUDA tensors, the plain PyTorch
    version for CPU tensors; "kernel" -> the CUDA kernel (raises on CPU
    tensors: there is no interpret mode); "ref" -> the plain version on any
    device. A kernel that fails to build or launch raises; nothing falls
    back to the plain version. Both routes differentiate: the kernel's
    backward recomputes the plain version (``_KernelSSM``).

    DTensors (a model on a mesh) run on their local shards through
    ``spmd.scan``: batch rows and channels.

    Launches are counted in ``ssm_scan.launches``: the forward's, and again
    a recomputed forward's under ``torch.utils.checkpoint``; the backward
    launches none.
    """
    if spmd.is_dtensor(u):
        # local_map: the kernel reads raw pointers, so a DTensor never
        # reaches it; a batch row's or a channel's scan is local
        def fn(u, dt, A, B, C):
            return ssm_scan_op(u, dt, A, B, C,
                               backend=backend)

        return spmd.scan(fn, u, dt, A, B, C,
                         maps=({0: 0, 2: 2}, {2: 0}, {0: 0}, {0: 0}),
                         channel=2)
    if backend == "auto":
        backend = "kernel" if u.is_cuda else "ref"
    if backend == "kernel":
        return _KernelSSM.apply(u, dt, A, B, C)
    if backend != "ref":
        raise ValueError(f"unknown ssm_scan backend: {backend!r}")
    return ssm_scan_ref(u, dt, A, B, C)
