"""Wrapper of the CUDA flash-attention kernels (``csrc/``).

Replaces the TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention``.
One launch computes causal or bidirectional GQA attention with an optional
sliding window and tanh soft-cap for every (batch, head, query tile), at any
sequence length: the kernels mask their own ragged edge. q may hold a slice
of the sequence's rows (``q_offset``: a rank's share of a sequence-sharded
q) against every key.

The route follows from the dtype alone (``route``): bf16 inputs take the
tensor-core kernel (``csrc/flash_attention_wgmma.cu``: wgmma, TMA, a
producer warpgroup and two consumer warpgroups, P as two bf16 halves); f32
inputs take the SIMT kernel (``csrc/flash_attention.cu``: f32 on the CUDA
cores), since on the tensor cores f32 would run as TF32 and miss its
tolerance.

Both kernels are built into one library with ``nvcc`` on first use
(``kernels/_build.py``) and called through ``ctypes`` on PyTorch's current
stream. They take CUDA tensors only; anything else raises. They compute
no gradient: ``ops.attention_op`` wraps them in the autograd function that
does.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import spmd
from repro_torch.kernels import _build
from repro_torch.kernels._autograd import check_no_grad

#: kernel launches since the last reset (one per attention layer a forward),
#: and the same launches by route
launches = 0
launches_wgmma = 0
launches_simt = 0

HEAD_DIMS = (32, 64, 112, 128, 224, 256)   # instantiated in both .cu files
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt"}
#: query rows a block (kBQ of each .cu)
BLOCK_Q = {"wgmma": 128, "simt": 64}
_ENTRY = {"wgmma": "flash_attention_wgmma_launch",
          "simt": "flash_attention_launch"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 9 + [_F, _F] + [_I] * 3 + [_P]  # as in the .cu


def route(dtype: torch.dtype) -> str:
    """The kernel a dtype takes: "wgmma" for bf16, "simt" for f32."""
    if dtype not in ROUTES:
        raise ValueError(f"flash_attention: unsupported dtype {dtype}")
    return ROUTES[dtype]


def launch_grid(B: int, H: int, Sq: int,
                route: str) -> tuple[int, int, int]:
    """The CUDA grid of a launch of ``route``'s kernel over ``Sq`` query
    rows: one block per (BLOCK_Q[route] query rows, head, batch row), in
    (x, y, z) order, the last row block ragged. ``geometry.py`` declares
    the same grid."""
    return (-(-Sq // BLOCK_Q[route]), H, B)


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        for name in _ENTRY.values():
            getattr(lib, name).argtypes = _ARGTYPES
            getattr(lib, name).restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0, scale=None):
    """q: [B,H,Sq,hd]; k, v: [B,K,Sk,hd] (K divides H), contiguous, f32
    or bf16, on one CUDA device -> [B,H,Sq,hd] in q's dtype. Query row i
    stands at position ``q_offset + i`` and key row j at j, with
    ``0 <= q_offset`` and ``q_offset + Sq <= Sk``. ``window`` > 0 keeps
    keys with ``q_pos - k_pos < window``; the scores are scaled by
    ``scale`` (``hd ** -0.5`` where None); ``softcap`` > 0 applies
    ``tanh(s / softcap) * softcap`` to the scaled scores. The output has
    no ``grad_fn``: under grad mode an input that requires grad raises
    (``ops.attention_op`` differentiates)."""
    if spmd.is_dtensor(q):
        raise TypeError("flash_attention reads raw pointers: pass local "
                        "tensors (a DTensor goes through ops.py's "
                        "local_map)")
    global launches, launches_wgmma, launches_simt
    check_no_grad("flash_attention", "ops.attention_op", q, k, v)
    if not isinstance(q, torch.Tensor) or not q.is_cuda:
        raise ValueError("flash_attention runs on CUDA tensors only; use "
                         "attention_ref for tensors on the host")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be 4-d")
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    kind = route(q.dtype)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if K < 1 or H % K:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {K} kv heads")
    if B < 1 or Sq < 1:
        raise ValueError(f"flash_attention: empty input {tuple(q.shape)}")
    if q_offset < 0 or q_offset + Sq > Sk:
        raise ValueError(f"flash_attention: query rows {q_offset} .. "
                         f"{q_offset + Sq - 1} do not lie in the {Sk} keys")
    dev = q.device
    for name, x, heads, S in (("q", q, H, Sq), ("k", k, K, Sk),
                              ("v", v, K, Sk)):
        _build.check_tensor("flash_attention", name, x, q.dtype,
                            (B, heads, S, hd), dev)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, _ENTRY[kind])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, K, Sq, Sk, int(q_offset), hd, int(bool(causal)),
            max(int(window), 0), hd ** -0.5 if scale is None else scale,
            float(softcap),
            *launch_grid(B, H, Sq, kind), stream,
        )
    if rc != 0:
        raise _build.launch_error("flash_attention", rc,
                                  lib.flash_attention_error_string,
                                  "unsupported head dim")
    launches += 1
    if kind == "wgmma":
        launches_wgmma += 1
    else:
        launches_simt += 1
    return out
