"""Wrapper of the CUDA flash-decode kernel (``csrc/flash_decode.cu``).

Replaces the TPU kernel
``repro/kernels/flash_decode/flash_decode.py::flash_decode``. One launch
attends one query token of every (batch row, head) to its KV cache up to
``pos``, with an optional sliding window and tanh soft-cap, reading the
caches in the decode state's own layout ``[B,S,K,hd]`` and only their
visible keys.

The kernel is built with ``nvcc`` on first use (``kernels/_build.py``) and
called through ``ctypes`` on PyTorch's current stream. It takes CUDA
tensors only; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches since the last reset (one per attention layer a step)
launches = 0

HEAD_DIMS = (32, 64, 112, 128, 256)   # instantiated in the .cu
SMEM_LIMIT = 232_448                  # bytes of shared memory a block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WARPS = 8                            # kWarps of the .cu

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P] * 5 + [_I] * 7 + [_F, _F, _I, _I, _P]  # as in the .cu


def smem_bytes(G: int, hd: int) -> int:
    """Dynamic shared memory of one launch (``smem_bytes`` of the .cu)."""
    return 4 * (G * hd * (1 + _WARPS) + 2 * _WARPS * G)


def launch_grid(B: int, K: int) -> tuple[int, int]:
    """The CUDA grid of a launch: one block per (kv head, batch row), in
    (x, y) order. ``geometry.py`` declares the same grid."""
    return (K, B)


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_decode")
    if lib.flash_decode_launch.argtypes is None:
        lib.flash_decode_launch.argtypes = _ARGTYPES
        lib.flash_decode_launch.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


def flash_decode(q, k_cache, v_cache, pos, *, softcap: float = 0.0,
                 window: int = 0):
    """q: [B,H,hd]; k_cache, v_cache: [B,S,K,hd] (K divides H), of q's
    dtype (f32 or bf16); pos: [B] int32 with ``0 <= pos < S``; all
    contiguous on one CUDA device -> [B,H,hd] in q's dtype. ``window`` > 0
    keeps keys with ``pos - j < window``; ``softcap`` > 0 applies
    ``tanh(s / softcap) * softcap`` to the scaled scores."""
    global launches
    if not isinstance(q, torch.Tensor) or not q.is_cuda:
        raise ValueError("flash_decode runs on CUDA tensors only; use "
                         "decode_attention_ref for tensors on the host")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("flash_decode: q must be 3-d and the caches 4-d")
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_decode: unsupported dtype {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {hd} not in {HEAD_DIMS}")
    if K < 1 or H % K:
        raise ValueError(f"flash_decode: {H} query heads are not a "
                         f"multiple of {K} kv heads")
    if B < 1 or S < 1:
        raise ValueError(f"flash_decode: empty input {tuple(k_cache.shape)}")
    if smem_bytes(H // K, hd) > SMEM_LIMIT:
        raise ValueError(f"flash_decode: a group of {H // K} queries of "
                         f"head dim {hd} does not fit in shared memory")
    dev = q.device
    for name, x, dtype, shape in (
            ("q", q, q.dtype, (B, H, hd)),
            ("k_cache", k_cache, q.dtype, (B, S, K, hd)),
            ("v_cache", v_cache, q.dtype, (B, S, K, hd)),
            ("pos", pos, torch.int32, (B,))):
        _build.check_tensor("flash_decode", name, x, dtype, shape, dev)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_decode_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, S, K, H // K, hd,
            _DTYPES[q.dtype], max(int(window), 0), hd ** -0.5,
            float(softcap), *launch_grid(B, K), stream,
        )
    if rc != 0:
        raise _build.launch_error("flash_decode", rc,
                                  lib.flash_decode_error_string,
                                  "unsupported head dim")
    launches += 1
    return out
