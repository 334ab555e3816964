"""Wrapper of the CUDA flash-decode kernels (``csrc/flash_decode.cu``).

Replaces the TPU kernel
``repro/kernels/flash_decode/flash_decode.py::flash_decode``. One call
attends one query token of every (batch row, head) to its KV cache up to
``pos``, with an optional sliding window and tanh soft-cap, reading the
caches in the decode state's own layout ``[B,S,K,hd]`` and only their
visible keys.

A call is two launches: a split pass, one warp per chunk of keys of each
(batch row, kv head) and one block per 4 adjacent kv heads, writes f32
partials (m, l, acc) to a workspace; a combine pass, one block per (batch
row, kv head), merges them in chunk order. The chunk size, and so the
number of chunks, follows from the shapes (``chunk_size``), never from
``pos``, which lies on the card: the wrapper never waits for it.

The kernels are built with ``nvcc`` on first use (``kernels/_build.py``) and
called through ``ctypes`` on PyTorch's current stream. They take CUDA
tensors only; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import spmd
from repro_torch.kernels import _build

#: calls since the last reset (one per attention layer a step); each call
#: is two launches, the split pass and the combine pass, counted apart
launches = 0
launches_split = 0
launches_combine = 0

HEAD_DIMS = (32, 64, 112, 128, 256)   # instantiated in the .cu
CHUNKS = (512, 1024, 2048)            # keys a split warp, by preference
#: split blocks that fill the card once at two blocks an SM (the H100's 132
#: SMs): a larger chunk is taken only while it leaves this many
FILL_BLOCKS = 2 * 132
MAX_GROUP = 8                         # query heads a kv head (kMaxGroup)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WARPS = 4                            # kWarps of the .cu: kv heads a block

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SPLIT_ARGTYPES = [_P] * 6 + [_I] * 8 + [_F, _F] + [_I] * 3 + [_P]
_COMBINE_ARGTYPES = [_P] * 3 + [_I] * 8 + [_P]   # as in the .cu


def chunk_size(B: int, K: int, S: int) -> int:
    """Keys a split warp takes: the largest of CHUNKS that still makes
    FILL_BLOCKS blocks (fewer blocks amortise a block's fixed cost over
    more keys), else the smallest. From the shapes alone, never from pos."""
    heads = -(-K // _WARPS)
    chunk = CHUNKS[0]
    for c in CHUNKS[1:]:
        if B * heads * -(-S // c) >= FILL_BLOCKS:
            chunk = c
    return chunk


def n_split(B: int, K: int, S: int) -> int:
    """Chunks of the split pass."""
    return -(-S // chunk_size(B, K, S))


def launch_grid(B: int, K: int, S: int) -> tuple[tuple[int, int, int],
                                                  tuple[int, int]]:
    """The CUDA grids of a call, in (x, y[, z]) order: the split pass's
    (n_split, ceil(K / 4), B) and the combine pass's (K, B).
    ``geometry.py`` declares the same grids."""
    return (n_split(B, K, S), -(-K // _WARPS), B), (K, B)


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_decode")
    if lib.flash_decode_split_launch.argtypes is None:
        lib.flash_decode_split_launch.argtypes = _SPLIT_ARGTYPES
        lib.flash_decode_split_launch.restype = ctypes.c_int
        lib.flash_decode_combine_launch.argtypes = _COMBINE_ARGTYPES
        lib.flash_decode_combine_launch.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


def flash_decode(q, k_cache, v_cache, pos, *, softcap: float = 0.0,
                 window: int = 0):
    """q: [B,H,hd]; k_cache, v_cache: [B,S,K,hd] (K divides H, H / K <=
    MAX_GROUP), of q's dtype (f32 or bf16); pos: [B] int32 with ``0 <= pos
    < S``; all contiguous on one CUDA device -> [B,H,hd] in q's dtype.
    ``window`` > 0 keeps keys with ``pos - j < window``; ``softcap`` > 0
    applies ``tanh(s / softcap) * softcap`` to the scaled scores. The split
    pass (``flash_decode_partials``) then the combine pass
    (``flash_decode_combine``)."""
    part_ml, part_acc = flash_decode_partials(q, k_cache, v_cache, pos,
                                              softcap=softcap, window=window)
    return flash_decode_combine(part_ml, part_acc, q.dtype)


def _refuse_dtensor(name: str, t) -> None:
    if spmd.is_dtensor(t):
        raise TypeError(f"{name} reads raw pointers: pass local tensors (a "
                        f"DTensor goes through ops.py's local_map)")


def flash_decode_partials(q, k_cache, v_cache, pos, *, softcap: float = 0.0,
                          window: int = 0):
    """The split pass alone: ``flash_decode``'s arguments (any int32
    ``pos``: keys past the cache's end are not there, and a chunk with no
    visible key gives an empty partial) -> the f32 partials (m, l) [B,K,
    n,G,2] and acc [B,K,n,G,hd] of its n = ``n_split(B, K, S)`` chunks, in
    chunk order: m the chunk's largest visible score (-1e30 if none),
    l the sum of exp(s - m), acc that of exp(s - m) v. A cache sharded on
    its sequence gives each rank's partials, which ``ops.py`` gathers in
    order for one combine."""
    _refuse_dtensor("flash_decode", q)
    global launches_split
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
    if H // K > MAX_GROUP:
        raise ValueError(f"flash_decode: a group of {H // K} query heads a "
                         f"kv head is more than the {MAX_GROUP} the kernel "
                         f"holds")
    if B < 1 or S < 1:
        raise ValueError(f"flash_decode: empty input {tuple(k_cache.shape)}")
    dev = q.device
    for name, x, dtype, shape in (
            ("q", q, q.dtype, (B, H, hd)),
            ("k_cache", k_cache, q.dtype, (B, S, K, hd)),
            ("v_cache", v_cache, q.dtype, (B, S, K, hd)),
            ("pos", pos, torch.int32, (B,))):
        _build.check_tensor("flash_decode", name, x, dtype, shape, dev)
    G = H // K
    chunk = chunk_size(B, K, S)
    split_grid, _ = launch_grid(B, K, S)
    part_ml = torch.empty((B, K, split_grid[0], G, 2), dtype=torch.float32,
                          device=dev)
    part_acc = torch.empty((B, K, split_grid[0], G, hd),
                           dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_decode_split_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(), B, S, K,
            G, hd, _DTYPES[q.dtype], chunk, max(int(window), 0), hd ** -0.5,
            float(softcap), *split_grid, stream,
        )
    if rc != 0:
        raise _build.launch_error("flash_decode", rc,
                                  lib.flash_decode_error_string,
                                  "unsupported head dim, group or chunk")
    launches_split += 1
    return part_ml, part_acc


def flash_decode_combine(part_ml, part_acc, dtype):
    """The combine pass alone: the partials [B,K,n,G,2] and [B,K,n,G,hd]
    (f32, contiguous, on one CUDA device), merged in chunk order ->
    [B,K*G,hd] in ``dtype``. Each call is one ``launches`` (with its
    split pass, or with the split passes of the ranks that hold a cache's
    slices)."""
    _refuse_dtensor("flash_decode", part_ml)
    global launches, launches_combine
    if part_ml.dim() != 5 or part_acc.dim() != 5:
        raise ValueError("flash_decode: the partials must be 5-d")
    B, K, n, G, hd = part_acc.shape
    if dtype not in _DTYPES:
        raise ValueError(f"flash_decode: unsupported dtype {dtype}")
    dev = part_acc.device
    if dev.type != "cuda":
        raise ValueError("flash_decode runs on CUDA tensors only")
    for name, x, shape in (("part_ml", part_ml, (B, K, n, G, 2)),
                           ("part_acc", part_acc, (B, K, n, G, hd))):
        _build.check_tensor("flash_decode", name, x, torch.float32, shape,
                            dev)
    out = torch.empty((B, K * G, hd), dtype=dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_decode_combine_launch(
            part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(), B, K,
            G, hd, n, _DTYPES[dtype], K, B, stream,
        )
    if rc != 0:
        raise _build.launch_error("flash_decode", rc,
                                  lib.flash_decode_error_string,
                                  "too many partials for the combine pass's "
                                  "shared memory")
    launches_combine += 1
    launches += 1
    return out
