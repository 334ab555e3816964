"""Wrapper of the CUDA window-query kernels (``csrc/window_query.cu``).

Replaces the TPU kernels ``repro/kernels/window_query/window_query.py::
window_query_batched`` and ``::window_query``: the §IV.B.2
multi-containment query, the earliest feasible start on each device, as a
masked min-reduce over its T·W windows. A group of ``group_size(T·W)``
lanes takes a (replica, device) row, each lane a chunk of 4 windows, the
group's min a butterfly of shuffles, and 8 warps a block take one
contiguous tile of ``rows_per_block(T·W)`` rows; the kernel masks its own
row edge, so no padding copy is made. Bit-identical to the plain versions
in ``ref.py``.

Two routes of the one kernel, chosen by ``route`` from the pointers and
strides: ``"vec"`` loads a chunk as 16 bytes of t1, 16 of t2 and 4 of
valid; ``"scalar"`` loads it element by element, for the layouts those
loads cannot take. Launches are counted by form (``launches``,
``launches_batched``) and by route (``launches_vec``,
``launches_scalar``).

The windows may be strided views whose inner [T, W] block is contiguous
(the fleet passes ``win_*[:, d:d+1, HP_IDX]`` as it lies); the batched
form's parameters may be any strided [B, Dev] view, broadcast ones
included. The kernels are built with ``nvcc`` on first use
(``kernels/_build.py``) and called through ``ctypes`` on PyTorch's current
stream. They take CUDA tensors only; anything else raises.

Bound: the windows' 9 bytes each, read once. Device time
(``tools/time_window_query.py`` call wq4, NVIDIA H100 80GB HBM3, 700 W):
29.9 µs at 262,144 devices (77% of the bound, L2 flushed), 3.00-3.01 µs
warm at B 8192 × Dev 4 (100%), 1.91 µs warm on the fleet's HP view,
against a near-empty launch's ~1.0; the csrc header has the rest. The
host's cost a call is several times that
(``chip_smoke.py::wq_host_split``): the stream is read as its raw handle,
the device made current only where it is not, and a ready parameter
passes the dispatcher as it is.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.window_query.ref import BIG

#: launches since the last reset, of each entry point (the fleet's HP query
#: makes 4 batched launches a tick) and of each route, both forms together
launches = 0
launches_batched = 0
launches_vec = 0
launches_scalar = 0

WARPS = 8          # warps a block (kWarps of the .cu)
ROUTES = ("vec", "scalar")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_BATCHED_ARGTYPES = [_P] * 8 + [_I] * 3 + [_L] * 12 + [_F, _I, _I, _P]
_ARGTYPES = [_P] * 5 + [_I] * 2 + [_L] * 3 + [_F] * 4 + [_I, _I, _P]


def group_size(tw: int) -> int:
    """Lanes a row: its ceil(tw / 4) chunks of 4 windows rounded up to a
    power of two, at most a warp (``group_for`` of the .cu)."""
    chunks, g = -(-tw // 4), 1
    while g < chunks and g < 32:
        g *= 2
    return g


def rows_per_block(tw: int) -> int:
    """Rows of one block's tile: ``WARPS`` warps of 32 / G rows."""
    return WARPS * (32 // group_size(tw))


def launch_grid(n_rows: int, tw: int) -> tuple[int]:
    """The CUDA grid of a launch over ``n_rows`` (replica, device) rows of
    ``tw`` windows: one block a tile of ``rows_per_block(tw)`` rows, the
    last tile ragged. ``geometry.py`` declares the same grid."""
    return (-(-n_rows // rows_per_block(tw)),)


def route(t1, t2, valid) -> str:
    """``"vec"`` where the 16-byte loads can take the windows: T·W a
    multiple of 4, every row start of t1 and t2 16-byte aligned and of valid
    4-byte aligned (the data pointers, and the stride of every outer dim
    longer than 1 a multiple of 4 elements); else ``"scalar"``. The C entry
    points refuse the vector route on any other layout."""
    xs = (t1, t2, valid)
    return _route(t1.shape, [x.data_ptr() for x in xs],
                  [x.stride() for x in xs])


def _route(shape, ptrs, strides) -> str:
    """``route`` from the windows' shape and each tensor's data pointer and
    strides, as the wrapper has them at hand."""
    if (shape[-2] * shape[-1]) % 4:
        return "scalar"
    for ptr, stride, align in zip(ptrs, strides, (16, 16, 4)):
        if ptr % align:
            return "scalar"
        for n, s in zip(shape[:-2], stride[:-2]):
            if n > 1 and s % 4:
                return "scalar"
    return "vec"


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


def _launch(kernel, fn, dev, args, vec: bool, grid) -> None:
    """Call C entry point ``fn`` with ``args``, the route, the grid and
    the current stream of ``dev``; count the route; raise on a failure.
    The stream is read as its raw handle
    (``torch.cuda.current_stream(dev).cuda_stream`` without building a
    ``Stream``), and the device is made current only where it is not: a
    kernel launches on the current device."""
    global launches_vec, launches_scalar
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, int(vec), *grid, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, int(vec), *grid, stream)
    if rc != 0:
        raise _build.launch_error(
            kernel, rc, _lib().window_query_error_string,
            unsupported="the vector route cannot load this layout")
    if vec:
        launches_vec += 1
    else:
        launches_scalar += 1


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
    xs = (t1, t2, valid, q1, deadline, dur)
    ptrs = [x.data_ptr() for x in xs]
    strides = [x.stride() for x in xs]
    _launch("window_query_batched", _lib().window_query_batched_launch, dev,
            (*ptrs, start.data_ptr(), found.data_ptr(), B, Dev, tw,
             *(s for st in strides for s in st[:2]), BIG),
            _route(t1.shape, ptrs, strides) == "vec",
            launch_grid(B * Dev, tw))
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
    xs = (t1, t2, valid)
    ptrs = [x.data_ptr() for x in xs]
    strides = [x.stride() for x in xs]
    _launch("window_query", _lib().window_query_launch, dev,
            (*ptrs, start.data_ptr(), found.data_ptr(), Dev, tw,
             *(st[0] for st in strides), float(q1), float(deadline),
             float(dur), BIG),
            _route(t1.shape, ptrs, strides) == "vec", launch_grid(Dev, tw))
    launches += 1
    return found, start
