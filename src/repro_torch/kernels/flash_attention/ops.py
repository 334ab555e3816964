"""Dispatching wrapper for prefill attention — the single source of the
backend policy; ``models/layers.py::attention`` sends every self-attention
on a CUDA tensor through here.

Unlike the JAX package's dispatcher, there is no fallback for a sequence
length that is not a multiple of the block: the CUDA kernel masks its own
ragged edge, so a CUDA tensor takes the kernel at every S.

The kernel route is differentiable: ``_KernelAttention`` runs the CUDA
kernel forward and, in the backward, recomputes ``attention_ref`` on the
saved inputs and takes its vjp (``kernels/_autograd.py``).
"""

from __future__ import annotations

import torch

from repro_torch import spmd
from repro_torch.kernels._autograd import recompute_vjp
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


class _KernelAttention(torch.autograd.Function):
    """The CUDA kernel forward; the backward is the vjp of
    ``attention_ref`` recomputed on the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, scale):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      q_offset=q_offset, scale=scale)
        return flash_attention(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, grad_out):
        return (*recompute_vjp(attention_ref, ctx, grad_out, **ctx.kw),
                None, None, None, None, None)


def attention_op(q, k, v, *, causal=True, window=0, softcap=0.0,
                 q_offset=0, scale=None, backend: str = "auto"):
    """q: [B,H,Sq,hd]; k, v: [B,K,Sk,hd] -> [B,H,Sq,hd], query row i at
    position ``q_offset + i`` (``q_offset + Sq <= Sk``; without an offset
    Sq = Sk). The scores are scaled by ``scale``, ``hd ** -0.5`` where
    None.

    backend: "auto" -> the CUDA kernel for CUDA tensors, the plain PyTorch
    version for CPU tensors; "kernel" -> the CUDA kernel (raises on CPU
    tensors: there is no interpret mode); "ref" -> the plain version on any
    device. A kernel that fails to build or launch raises; nothing falls
    back to the plain version. Both routes differentiate: the kernel's
    backward recomputes the plain version (``_KernelAttention``).

    DTensors (a model on a mesh) run on their local shards through
    ``spmd.attend``: q sharded by batch rows, heads or sequence; a rank's
    share of a sequence-sharded q goes in at its first row's position
    against every key, whose gradients are then partial sums over the
    shares.

    Launches are counted in ``flash_attention.launches``: the forward's, and
    again a recomputed forward's under ``torch.utils.checkpoint``; the
    backward launches none.
    """
    if spmd.is_dtensor(q):
        # local_map: the kernel reads raw pointers, so a DTensor never
        # reaches it; the work of a batch row, a q head or a share of the
        # q rows against every key is local
        def core(ql, kl, vl, s0):
            return attention_op(ql.contiguous(), kl.contiguous(),
                                vl.contiguous(), causal=causal,
                                window=window, softcap=softcap,
                                q_offset=q_offset + s0, scale=scale,
                                backend=backend)

        return spmd.attend(core, q, k, v, q_heads=1, kv_heads=1, q_seq=2)
    if backend == "auto":
        backend = "kernel" if q.is_cuda else "ref"
    if backend == "kernel":
        return _KernelAttention.apply(q, k, v, causal, window, softcap,
                                      q_offset, scale)
    if backend != "ref":
        raise ValueError(f"unknown attention backend: {backend!r}")
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap, q_offset=q_offset, scale=scale)
