"""Wrapper of the CUDA window-query kernels (``csrc/window_query.cu``).

Replaces the TPU kernels ``repro/kernels/window_query/window_query.py::
window_query_batched`` and ``::window_query``: the §IV.B.2
multi-containment query, the earliest feasible start on each device, as a
masked min-reduce over its T·W windows. One warp a (replica, device) row,
8 rows a block; the kernel masks its own row edge, so no padding copy is
made. Bit-identical to the plain versions in ``ref.py``.

The windows may be strided views whose inner [T, W] block is contiguous
(the fleet passes ``win_*[:, d:d+1, HP_IDX]`` as it lies); the batched
form's parameters may be any strided [B, Dev] view, broadcast ones
included. The kernels are built with ``nvcc`` on first use
(``kernels/_build.py``) and called through ``ctypes`` on PyTorch's current
stream. They take CUDA tensors only; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.window_query.ref import BIG

#: launches since the last reset, of each entry point (the fleet's HP query
#: makes 4 batched launches a tick)
launches = 0
launches_batched = 0

ROWS_PER_BLOCK = 8     # one warp a (replica, device) row, 256 threads

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_BATCHED_ARGTYPES = [_P] * 8 + [_I] * 3 + [_L] * 12 + [_F, _I, _P]
_ARGTYPES = [_P] * 5 + [_I] * 2 + [_L] * 3 + [_F] * 4 + [_I, _P]


def launch_grid(n_rows: int) -> tuple[int]:
    """The CUDA grid of a launch over ``n_rows`` (replica, device) rows:
    one block of ``ROWS_PER_BLOCK`` warps each, the last block ragged.
    ``geometry.py`` declares the same grid."""
    return (-(-n_rows // ROWS_PER_BLOCK),)


def _lib() -> ctypes.CDLL:
    lib = _build.library("window_query")
    if lib.window_query_launch.argtypes is None:
        lib.window_query_batched_launch.argtypes = _BATCHED_ARGTYPES
        lib.window_query_batched_launch.restype = ctypes.c_int
        lib.window_query_launch.argtypes = _ARGTYPES
        lib.window_query_launch.restype = ctypes.c_int
        lib.window_query_error_string.argtypes = [ctypes.c_int]
        lib.window_query_error_string.restype = ctypes.c_char_p
    return lib


def _check_windows(kernel, t1, t2, valid, n_lead: int):
    """The window tensors: f32, f32 and bool of one shape, ``n_lead`` dims
    and then [T, W], each [T, W] block contiguous. Returns T·W."""
    if not isinstance(t1, torch.Tensor) or not t1.is_cuda:
        raise ValueError(f"{kernel} runs on CUDA tensors only; use "
                         f"{kernel}_ref for tensors on the host")
    if t1.dim() != n_lead + 2:
        raise ValueError(f"{kernel}: windows must be {n_lead + 2}-d, not "
                         f"{tuple(t1.shape)}")
    shape = tuple(t1.shape)
    if shape[-2] * shape[-1] < 1:
        raise ValueError(f"{kernel}: no windows in {shape}")
    for name, x, dtype in (("t1", t1, torch.float32),
                           ("t2", t2, torch.float32),
                           ("valid", valid, torch.bool)):
        _build.check_strided(kernel, name, x, dtype, shape, t1.device,
                             inner=2)
    return shape[-2] * shape[-1]


def window_query_batched(t1, t2, valid, q1, deadline, dur):
    """t1, t2: f32 [B,Dev,T,W]; valid: bool, same shape (each [T, W] block
    contiguous); q1, deadline, dur: f32 [B,Dev], any strides, on the same
    CUDA device -> (found [B,Dev] i32, start [B,Dev] f32)."""
    global launches_batched
    tw = _check_windows("window_query_batched", t1, t2, valid, 2)
    B, Dev = t1.shape[:2]
    dev = t1.device
    for name, x in (("q1", q1), ("deadline", deadline), ("dur", dur)):
        _build.check_strided("window_query_batched", name, x, torch.float32,
                             (B, Dev), dev, inner=0)
    start = torch.empty((B, Dev), dtype=torch.float32, device=dev)
    found = torch.empty((B, Dev), dtype=torch.int32, device=dev)
    lib = _lib()
    strides = [s for x in (t1, t2, valid, q1, deadline, dur)
               for s in x.stride()[:2]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.window_query_batched_launch(
            t1.data_ptr(), t2.data_ptr(), valid.data_ptr(), q1.data_ptr(),
            deadline.data_ptr(), dur.data_ptr(), start.data_ptr(),
            found.data_ptr(), B, Dev, tw, *strides, BIG,
            *launch_grid(B * Dev), stream,
        )
    if rc != 0:
        raise _build.launch_error("window_query_batched", rc,
                                  lib.window_query_error_string)
    launches_batched += 1
    return found, start


def window_query(t1, t2, valid, q1: float, deadline: float, dur: float):
    """t1, t2: f32 [Dev,T,W]; valid: bool, same shape (each [T, W] block
    contiguous), on one CUDA device; q1, deadline, dur: Python numbers,
    rounded to f32 -> (found [Dev] i32, start [Dev] f32)."""
    global launches
    tw = _check_windows("window_query", t1, t2, valid, 1)
    Dev = t1.shape[0]
    dev = t1.device
    start = torch.empty((Dev,), dtype=torch.float32, device=dev)
    found = torch.empty((Dev,), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.window_query_launch(
            t1.data_ptr(), t2.data_ptr(), valid.data_ptr(), start.data_ptr(),
            found.data_ptr(), Dev, tw, t1.stride(0), t2.stride(0),
            valid.stride(0), float(q1), float(deadline), float(dur), BIG,
            *launch_grid(Dev), stream,
        )
    if rc != 0:
        raise _build.launch_error("window_query", rc,
                                  lib.window_query_error_string)
    launches += 1
    return found, start
