"""Wrapper of the CUDA SSD-scan kernel (``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``repro/kernels/ssd_scan/ssd_scan.py::ssd_scan``.
One launch scans every (batch row, head) of a Mamba-2 block over the whole
sequence in the chunked block form, at any S: the kernel masks its own
ragged edge. A block takes ``BLOCK_P`` columns of the head dim (the
P-split); bf16 runs on the tensor cores, f32 on the CUDA cores.

The kernel is built with ``nvcc`` on first use (``kernels/_build.py``) and
called through ``ctypes`` on PyTorch's current stream. It takes CUDA
tensors only; anything else raises. It computes no gradient:
``ops.ssd_scan_op`` wraps it in the autograd function that does.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import spmd
from repro_torch.kernels import _build
from repro_torch.kernels._autograd import check_no_grad

#: kernel launches since the last reset (one per Mamba-2 block a forward)
launches = 0

SHAPES = ((64, 64),)   # (head dim P, state dim N) instantiated: zamba2's
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 10 + [_P]   # as in ssd_scan_launch

BLOCK_P = 16   # columns of the head dim a block (kPB of the .cu)


def launch_grid(B: int, H: int, P: int) -> tuple[int, int, int]:
    """The CUDA grid of a launch, both routes: one block per (``BLOCK_P``
    columns of P, head, batch row), in (x, y, z) order. ``geometry.py``
    declares the same grid."""
    return (P // BLOCK_P, H, B)


def _lib() -> ctypes.CDLL:
    lib = _build.library("ssd_scan")
    if lib.ssd_scan_launch.argtypes is None:
        lib.ssd_scan_launch.argtypes = _ARGTYPES
        lib.ssd_scan_launch.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan(x, dt, A, B, C):
    """x: [B,S,H,P]; dt: [B,S,H] f32; A: [H] f32; B, C: [B,S,N] (one
    state group) or [B,S,G,N] (G groups, G dividing H: head h reads group
    ``h // (H // G)``); x, B and C of one dtype (f32 or bf16), all
    contiguous on one CUDA device, x, B and C 16-byte aligned -> y
    [B,S,H,P] in x's dtype. The output has no ``grad_fn``: under grad mode
    an input that requires grad raises (``ops.ssd_scan_op``
    differentiates)."""
    if spmd.is_dtensor(x):
        raise TypeError("ssd_scan reads raw pointers: pass local "
                        "tensors (a DTensor goes through ops.py's "
                        "local_map)")
    global launches
    check_no_grad("ssd_scan", "ops.ssd_scan_op", x, dt, A, B, C)
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError("ssd_scan runs on CUDA tensors only; use "
                         "ssd_scan_ref for tensors on the host")
    if x.dim() != 4 or B.dim() not in (3, 4):
        raise ValueError("ssd_scan: x must be 4-d and B 3-d or 4-d")
    Bsz, S, H, P = x.shape
    G, N = (1, B.shape[2]) if B.dim() == 3 else B.shape[2:]
    if H % G:
        raise ValueError(f"ssd_scan: {G} state groups do not divide {H} "
                         "heads")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: unsupported dtype {x.dtype}")
    if (P, N) not in SHAPES:
        raise ValueError(f"ssd_scan: (head dim, state dim) {(P, N)} not in "
                         f"{SHAPES}")
    if Bsz < 1 or S < 1 or H < 1:
        raise ValueError(f"ssd_scan: empty input {tuple(x.shape)}")
    dev = x.device
    for name, t, dtype, shape in (
            ("x", x, x.dtype, (Bsz, S, H, P)),
            ("dt", dt, torch.float32, (Bsz, S, H)),
            ("A", A, torch.float32, (H,)),
            ("B", B, x.dtype, (Bsz, S, *B.shape[2:])),
            ("C", C, x.dtype, (Bsz, S, *B.shape[2:]))):
        _build.check_tensor("ssd_scan", name, t, dtype, shape, dev)
        if name in ("x", "B", "C") and t.data_ptr() % 16:
            raise ValueError(f"ssd_scan: {name} is not 16-byte aligned")
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), Bsz, S, H, P, N, G,
            _DTYPES[x.dtype],
            *launch_grid(Bsz, H, P), stream,
        )
    if rc != 0:
        raise _build.launch_error("ssd_scan", rc, lib.ssd_scan_error_string,
                                  "unsupported (head dim, state dim)")
    launches += 1
    return y
