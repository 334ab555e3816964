"""Dispatching wrapper for decode attention — the single source of the
backend policy; ``models/layers.py::attention_decode`` sends every decode
step of a CUDA tensor through here.

Unlike the JAX package's dispatcher, there is no fallback for a cache
length that is not a multiple of the block: the CUDA kernel visits only the
visible keys and masks its own ragged edge, at any S and any window.
"""

from __future__ import annotations

from repro_torch.kernels.flash_decode.flash_decode import flash_decode
from repro_torch.kernels.flash_decode.ref import decode_attention_ref


def decode_attention_op(q, k_cache, v_cache, pos, *, softcap=0.0, window=0,
                        backend: str = "auto"):
    """q: [B,H,hd]; k_cache, v_cache: [B,S,K,hd]; pos: [B] int32
    -> [B,H,hd].

    backend: "auto" -> the CUDA kernel for CUDA tensors, the plain PyTorch
    version for CPU tensors; "kernel" -> the CUDA kernel (raises on CPU
    tensors: there is no interpret mode); "ref" -> the plain version on any
    device. A kernel that fails to build or launch raises; nothing falls
    back to the plain version.

    Launches are counted in ``flash_decode.launches``.
    """
    if backend == "auto":
        backend = "kernel" if q.is_cuda else "ref"
    if backend == "kernel":
        return flash_decode(q, k_cache, v_cache, pos, softcap=softcap,
                            window=window)
    if backend != "ref":
        raise ValueError(f"unknown decode attention backend: {backend!r}")
    return decode_attention_ref(q, k_cache, v_cache, pos, softcap=softcap,
                                window=window)
