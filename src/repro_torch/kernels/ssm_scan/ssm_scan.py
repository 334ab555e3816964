"""Wrapper of the CUDA selective-scan kernel (``csrc/ssm_scan.cu``).

Replaces the TPU kernel ``repro/kernels/ssm_scan/ssm_scan.py::ssm_scan``.
One launch scans every (batch row, channel) of a Mamba-1 block over the
whole sequence, at any S and at any d_inner whose rows are whole 16-byte
vectors (a multiple of 8 in bf16, of 4 in f32): the kernel masks its own
ragged edges. ``LANES`` lanes of a warp share a channel's state.

The kernel is built with ``nvcc`` on first use (``kernels/_build.py``) and
called through ``ctypes`` on PyTorch's current stream. It takes CUDA
tensors only; anything else raises. It computes no gradient:
``ops.ssm_scan_op`` wraps it in the autograd function that does.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import spmd
from repro_torch.kernels import _build
from repro_torch.kernels._autograd import check_no_grad

#: kernel launches since the last reset (one per Mamba-1 block a forward)
launches = 0

STATE_DIMS = (16,)   # N instantiated in the .cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 7 + [_P]   # as in ssm_scan_launch

THREADS = 128              # threads a block (kThreads of the .cu)
LANES = 8                  # lanes a channel (kLanes of the .cu)
BLOCK_D = THREADS // LANES   # channels a block


def launch_grid(B: int, di: int) -> tuple[int, int]:
    """The CUDA grid of a launch: one block per (``BLOCK_D`` channels,
    batch row), in (x, y) order, the last channel block ragged.
    ``geometry.py`` declares the same grid."""
    return (-(-di // BLOCK_D), B)


def _lib() -> ctypes.CDLL:
    lib = _build.library("ssm_scan")
    if lib.ssm_scan_launch.argtypes is None:
        lib.ssm_scan_launch.argtypes = _ARGTYPES
        lib.ssm_scan_launch.restype = ctypes.c_int
        lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssm_scan(u, dt, A, B, C):
    """u, dt: [B,S,di]; A: [di,N] f32; B, C: [B,S,N]; u, dt, B and C of one
    dtype (f32 or bf16), contiguous and 16-byte aligned, on one CUDA device
    -> y [B,S,di] in u's dtype. The output has no ``grad_fn``: under grad
    mode an input that requires grad raises (``ops.ssm_scan_op``
    differentiates)."""
    if spmd.is_dtensor(u):
        raise TypeError("ssm_scan reads raw pointers: pass local "
                        "tensors (a DTensor goes through ops.py's "
                        "local_map)")
    global launches
    check_no_grad("ssm_scan", "ops.ssm_scan_op", u, dt, A, B, C)
    if not isinstance(u, torch.Tensor) or not u.is_cuda:
        raise ValueError("ssm_scan runs on CUDA tensors only; use "
                         "ssm_scan_ref for tensors on the host")
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError("ssm_scan: u must be 3-d and A 2-d")
    Bsz, S, di = u.shape
    N = A.shape[1]
    if u.dtype not in _DTYPES:
        raise ValueError(f"ssm_scan: unsupported dtype {u.dtype}")
    if N not in STATE_DIMS:
        raise ValueError(f"ssm_scan: state dim {N} not in {STATE_DIMS}")
    if Bsz < 1 or S < 1 or di < 1:
        raise ValueError(f"ssm_scan: empty input {tuple(u.shape)}")
    if (di * u.element_size()) % 16:
        raise ValueError(f"ssm_scan: d_inner {di} is not a whole number of "
                         f"16-byte vectors of {u.dtype}")
    dev = u.device
    for name, x, dtype, shape in (
            ("u", u, u.dtype, (Bsz, S, di)), ("dt", dt, u.dtype, (Bsz, S, di)),
            ("A", A, torch.float32, (di, N)), ("B", B, u.dtype, (Bsz, S, N)),
            ("C", C, u.dtype, (Bsz, S, N))):
        _build.check_tensor("ssm_scan", name, x, dtype, shape, dev)
        if name != "A" and x.data_ptr() % 16:
            raise ValueError(f"ssm_scan: {name} is not 16-byte aligned")
    y = torch.empty_like(u)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssm_scan_launch(
            u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), Bsz, S, di, N, _DTYPES[u.dtype],
            *launch_grid(Bsz, di), stream,
        )
    if rc != 0:
        raise _build.launch_error("ssm_scan", rc, lib.ssm_scan_error_string,
                                  "unsupported state dim")
    launches += 1
    return y
