"""Wrappers of the CUDA placement kernels (``csrc/placement.cu``).

``fused_place`` replaces the TPU kernel
``repro/kernels/placement/placement.py::fused_place``. One launch makes one
LP placement attempt for every replica of the fleet: query, device
selection and fan-out commit, bit-identical to ``ref.fused_place_ref``.
``fanout_commit`` is the fan-out commit alone, of a given slot on one
device, for every replica in one launch (the fleet's HP commit),
bit-identical to ``core/tensor_state.fanout_commit``. Both commit in place:
the window tensors passed in are updated and returned as the first three
outputs.

The kernels are built with ``nvcc`` on first use (``kernels/_build.py``),
one library for both, and called through ``ctypes`` on PyTorch's current
stream. They take CUDA tensors only; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.tensor_state import BIG, OCC_TABLE
from repro_torch.kernels import _build
from repro_torch.kernels.placement.ref import SRC_PREF

#: kernel launches since the last reset: ``fused_place`` (the fleet engine
#: makes 21 a tick) and ``fanout_commit`` (4 a tick)
launches = 0
launches_fanout_commit = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P] * 15 + [_I] * 7 + [_F, _F, _I, _P]  # as in fused_place_launch
#: as in fanout_commit_launch
_FANOUT_ARGTYPES = [_P] * 9 + [_I] * 7 + [_F, _I, _P]

#: OCC_TABLE packed into 3-bit fields, row-major over (task cfg, list cfg)
_OCC_BITS = sum(
    int(v) << (3 * i) for i, v in enumerate(OCC_TABLE.reshape(-1))
)
_SHAPES_BUILT = {(2, 16)}   # (T, W) instantiated in the .cu
BLOCK_B = 8                 # replicas a block, one a warp (kWarps)


def launch_grid(B: int) -> tuple[int]:
    """The CUDA grid of a launch over B replicas: blocks of ``BLOCK_B``,
    the last one ragged. ``geometry.py`` declares the same grid."""
    return (-(-B // BLOCK_B),)


def _lib() -> ctypes.CDLL:
    lib = _build.library("placement")
    if lib.fused_place_launch.argtypes is None:
        lib.fused_place_launch.argtypes = _ARGTYPES
        lib.fused_place_launch.restype = ctypes.c_int
        lib.fused_place_error_string.argtypes = [ctypes.c_int]
        lib.fused_place_error_string.restype = ctypes.c_char_p
        lib.fanout_commit_launch.argtypes = _FANOUT_ARGTYPES
        lib.fanout_commit_launch.restype = ctypes.c_int
    return lib


def fused_place(t1, t2, valid, min_dur, q1, dl, src, do, *,
                cfg_pref: int = 1, cfg_fallback: int = 2, counts=None):
    """One fused placement attempt for the whole batch in one launch.

    t1, t2: f32 [B, Dev, 3, 2, 16]; valid: bool, same
    shape; min_dur: f32 [B, 3]; q1, dl: f32 [B, Dev]; src: i32 [B];
    do: bool [B]; all contiguous on one CUDA device. ``counts``, an int64
    [2] tensor there or None, gets the rows attempted (``do``) and
    committed (``ok``) added in the launch. Returns
    ``(t1, t2, valid, ok, sel, start, dur, use4, n_dropped)`` — the first
    three are the inputs, committed in place.
    """
    global launches
    if not isinstance(t1, torch.Tensor) or not t1.is_cuda:
        raise ValueError("fused_place runs on CUDA tensors only; use "
                         "fused_place_ref for tensors on the host")
    B, n_dev, n_cfg, T, W = t1.shape
    if n_cfg != 3 or (T, W) not in _SHAPES_BUILT or n_dev < 1:
        raise ValueError(f"fused_place: unsupported window shape "
                         f"{tuple(t1.shape)}")
    dev = t1.device
    win = (B, n_dev, n_cfg, T, W)
    for name, x, dtype, shape in (
            ("t1", t1, torch.float32, win), ("t2", t2, torch.float32, win),
            ("valid", valid, torch.bool, win),
            ("min_dur", min_dur, torch.float32, (B, n_cfg)),
            ("q1", q1, torch.float32, (B, n_dev)),
            ("dl", dl, torch.float32, (B, n_dev)),
            ("src", src, torch.int32, (B,)), ("do", do, torch.bool, (B,))):
        _build.check_tensor("fused_place", name, x, dtype, shape, dev)
    if counts is not None:
        _build.check_tensor("fused_place", "counts", counts, torch.int64,
                            (2,), dev)
    for c in (cfg_pref, cfg_fallback):
        if not 0 <= c < n_cfg:
            raise ValueError(f"fused_place: config index {c} out of range")
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    sel = torch.empty((B,), dtype=torch.int32, device=dev)
    start = torch.empty((B,), dtype=torch.float32, device=dev)
    dur = torch.empty((B,), dtype=torch.float32, device=dev)
    use4 = torch.empty((B,), dtype=torch.bool, device=dev)
    n_drop = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_place_launch(
            t1.data_ptr(), t2.data_ptr(), valid.data_ptr(),
            min_dur.data_ptr(), q1.data_ptr(), dl.data_ptr(), src.data_ptr(),
            do.data_ptr(), ok.data_ptr(), sel.data_ptr(), start.data_ptr(),
            dur.data_ptr(), use4.data_ptr(), n_drop.data_ptr(),
            None if counts is None else counts.data_ptr(),
            B, n_dev, T, W, cfg_pref, cfg_fallback, _OCC_BITS, BIG, SRC_PREF,
            *launch_grid(B), stream,
        )
    if rc != 0:
        raise _build.launch_error("fused_place", rc,
                                  lib.fused_place_error_string,
                                  "unsupported (T, W)")
    launches += 1
    return t1, t2, valid, ok, sel, start, dur, use4, n_drop


def fanout_commit(t1, t2, valid, min_dur, dev: int, cfg: int, s, e, do, *,
                  counts=None):
    """The §IV.A.1 fan-out commit of ``[s, e)`` on device ``dev`` for a task
    of config ``cfg``, for the whole batch in one launch, in place.

    t1, t2: f32 [B, Dev, 3, 2, 16]; valid: bool, same shape; min_dur: f32
    [B, 3]; s, e: f32 [B]; do: bool [B]; all contiguous on one CUDA
    device. Rows with ``do`` false are neither read nor written.
    ``counts``, an int64 [2] tensor there or None, gets the rows committed
    (``do``) and the rows whose windows the commit changed added in the
    launch. Returns ``(t1, t2, valid, n_dropped)``: the inputs, committed
    in place, and the int32 [B] count of remainders dropped for want of a
    slot (``core/tensor_state.fanout_commit``'s first four outputs).
    """
    global launches_fanout_commit
    if not isinstance(t1, torch.Tensor) or not t1.is_cuda:
        raise ValueError("fanout_commit runs on CUDA tensors only; use "
                         "tensor_state.fanout_commit for tensors on the host")
    B, n_dev, n_cfg, T, W = t1.shape
    if n_cfg != 3 or (T, W) not in _SHAPES_BUILT or n_dev < 1:
        raise ValueError(f"fanout_commit: unsupported window shape "
                         f"{tuple(t1.shape)}")
    if not 0 <= dev < n_dev:
        raise ValueError(f"fanout_commit: device {dev} out of range")
    if not 0 <= cfg < n_cfg:
        raise ValueError(f"fanout_commit: config index {cfg} out of range")
    device = t1.device
    win = (B, n_dev, n_cfg, T, W)
    for name, x, dtype, shape in (
            ("t1", t1, torch.float32, win), ("t2", t2, torch.float32, win),
            ("valid", valid, torch.bool, win),
            ("min_dur", min_dur, torch.float32, (B, n_cfg)),
            ("s", s, torch.float32, (B,)), ("e", e, torch.float32, (B,)),
            ("do", do, torch.bool, (B,))):
        _build.check_tensor("fanout_commit", name, x, dtype, shape, device)
    if counts is not None:
        _build.check_tensor("fanout_commit", "counts", counts, torch.int64,
                            (2,), device)
    n_drop = torch.empty((B,), dtype=torch.int32, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fanout_commit_launch(
            t1.data_ptr(), t2.data_ptr(), valid.data_ptr(),
            min_dur.data_ptr(), s.data_ptr(), e.data_ptr(), do.data_ptr(),
            n_drop.data_ptr(), None if counts is None else counts.data_ptr(),
            B, n_dev, T, W, dev, cfg, _OCC_BITS, BIG, *launch_grid(B),
            stream,
        )
    if rc != 0:
        raise _build.launch_error("fanout_commit", rc,
                                  lib.fused_place_error_string,
                                  "unsupported (T, W)")
    launches_fanout_commit += 1
    return t1, t2, valid, n_drop
