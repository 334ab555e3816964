"""Dispatching wrapper for prefill attention — the single source of the
backend policy; ``models/layers.py::attention`` sends every self-attention
on a CUDA tensor through here.

Unlike the JAX package's dispatcher, there is no fallback for a sequence
length that is not a multiple of the block: the CUDA kernel masks its own
ragged edge, so a CUDA tensor takes the kernel at every S.
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention_op(q, k, v, *, causal=True, window=0, softcap=0.0,
                 backend: str = "auto"):
    """q: [B,H,S,hd]; k, v: [B,K,S,hd] -> [B,H,S,hd].

    backend: "auto" -> the CUDA kernel for CUDA tensors, the plain PyTorch
    version for CPU tensors; "kernel" -> the CUDA kernel (raises on CPU
    tensors: there is no interpret mode); "ref" -> the plain version on any
    device. A kernel that fails to build or launch raises; nothing falls
    back to the plain version.

    Launches are counted in ``flash_attention.launches``.
    """
    if backend == "auto":
        backend = "kernel" if q.is_cuda else "ref"
    if backend == "kernel":
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    if backend != "ref":
        raise ValueError(f"unknown attention backend: {backend!r}")
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap)
