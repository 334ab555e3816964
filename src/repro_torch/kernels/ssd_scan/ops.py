"""Dispatching wrapper for the SSD scan — the single source of the backend
policy; ``models/ssm.py::mamba2_forward`` sends every scan of a CUDA tensor
through here.

Unlike the JAX package's dispatcher, there is no fallback for a sequence
that is not a multiple of the chunk or a head count that is not a multiple
of the head block: the CUDA kernel takes any S and any H.

The kernel route is differentiable: ``_KernelSSD`` runs the CUDA kernel
forward and, in the backward, recomputes the chunked form
``ssd_chunked_ref`` on the saved inputs and takes its vjp
(``kernels/_autograd.py``); the step-by-step oracle would take seconds a
call to differentiate at a model's length.
"""

from __future__ import annotations

import torch

from repro_torch import spmd
from repro_torch.kernels._autograd import recompute_vjp
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan


class _KernelSSD(torch.autograd.Function):
    """The CUDA kernel forward; the backward is the vjp of
    ``ssd_chunked_ref`` in chunks of ``chunk``, recomputed on the saved
    inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return ssd_scan(x, dt, A, B, C)

    @staticmethod
    def backward(ctx, grad_out):
        return (*recompute_vjp(ssd_chunked_ref, ctx, grad_out, ctx.chunk),
                None)


def ssd_scan_op(x, dt, A, B, C, *, backend: str = "auto",
                chunk: int = 256):
    """x: [B,S,H,P]; dt: [B,S,H]; A: [H]; B, C: [B,S,N], or [B,S,G,N] in
    G state groups of the heads -> [B,S,H,P].

    backend: "auto" -> the CUDA kernel for CUDA tensors, the plain PyTorch
    version for CPU tensors; "kernel" -> the CUDA kernel (raises on CPU
    tensors: there is no interpret mode); "ref" -> the plain version on any
    device. A kernel that fails to build or launch raises; nothing falls
    back to the plain version. Both routes differentiate; the kernel's
    backward recomputes ``ssd_chunked_ref`` in blocks of ``chunk`` steps
    (the model's ``ssm_chunk``), so a gradient through the kernel needs S a
    multiple of ``chunk``.

    DTensors (a model on a mesh) run on their local shards through
    ``spmd.scan``: batch rows and channels, with one state group (a head
    shard would need its own groups of B and C).

    Launches are counted in ``ssd_scan.launches``: the forward's, and again
    a recomputed forward's under ``torch.utils.checkpoint``; the backward
    launches none.
    """
    if spmd.is_dtensor(x):
        if B.dim() == 4:
            raise NotImplementedError("ssd_scan_op on a mesh takes one "
                                      "state group")
        # local_map: the kernel reads raw pointers, so a DTensor never
        # reaches it; a batch row's or a channel's scan is local
        def fn(x, dt, A, B, C):
            return ssd_scan_op(x, dt, A, B, C,
                               backend=backend, chunk=chunk)

        return spmd.scan(fn, x, dt, A, B, C,
                         maps=({0: 0, 2: 2}, {2: 0}, {0: 0}, {0: 0}),
                         channel=2)
    if backend == "auto":
        backend = "kernel" if x.is_cuda else "ref"
    if backend == "kernel":
        return _KernelSSD.apply(x, dt, A, B, C, chunk)
    if backend != "ref":
        raise ValueError(f"unknown ssd_scan backend: {backend!r}")
    return ssd_scan_ref(x, dt, A, B, C)
