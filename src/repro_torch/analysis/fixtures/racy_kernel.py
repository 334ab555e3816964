"""A deliberately racy CUDA kernel and the launch geometries that trip
each violation class of the checker.

``racy_sum`` (``csrc/racy_sum.cu``) is a real, runnable kernel: a grid of
2 blocks in which block i writes ``x[i·n:(i+1)·n] · (i+1)`` over the same
n outputs. On the card the two blocks race, and each output is whichever
block wrote it last; the JAX package's interpret mode runs its grid in
order, so there the last writer always wins (``racy_sum_ref``). Either way
half of the input vanishes from the output that a correct reduction would
give (``racy_sum_oracle``): the silent corruption that the checker rules
out statically. The three geometry providers feed the checker's write-race,
out-of-bounds and alias classes.

This module lives under ``analysis/fixtures/``, outside ``kernels/``, so
the production registry never loads it; the tests, ``chip_smoke.py`` and
the ``--fixture`` flag pull it in. Its library builds through
``kernels/_build.py`` like a kernel's (``_build.SOURCE_DIRS``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.launch_check import BlockDecl, KernelGeometry
from repro_torch.kernels import _build

_MODULE = "repro_torch.analysis.fixtures.racy_kernel"

#: launches since the last reset
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


#: the CUDA grid of ``racy_sum``: 2 blocks, one for each half of the
#: input, whatever its length; ``race_geometry`` declares the same grid
GRID = (2,)


def _lib() -> ctypes.CDLL:
    lib = _build.library("racy_sum")
    if lib.racy_sum_launch.argtypes is None:
        lib.racy_sum_launch.argtypes = _ARGTYPES
        lib.racy_sum_launch.restype = ctypes.c_int
        lib.racy_sum_error_string.argtypes = [ctypes.c_int]
        lib.racy_sum_error_string.restype = ctypes.c_char_p
    return lib


def racy_sum(x):
    """x: f32 [2n], contiguous on a CUDA device -> [n]. Both blocks write
    every output: the result is not defined."""
    global launches
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError("racy_sum runs on CUDA tensors only; use "
                         "racy_sum_ref for tensors on the host")
    if x.dim() != 1 or x.shape[0] % 2:
        raise ValueError(f"racy_sum: x must be 1-d of even length, not "
                         f"{tuple(x.shape)}")
    n = x.shape[0] // 2
    _build.check_tensor("racy_sum", "x", x, torch.float32, (2 * n,),
                        x.device)
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.racy_sum_launch(x.data_ptr(), out.data_ptr(), n, *GRID,
                                 stream)
    if rc != 0:
        raise _build.launch_error("racy_sum", rc, lib.racy_sum_error_string)
    launches += 1
    return out


def racy_sum_ref(x):
    """The racy launch with its grid run in order, as the JAX package's
    interpret mode runs it: the last block (scale 2) wins every output."""
    n = x.shape[0] // 2
    return x[n:] * 2.0


def racy_sum_oracle(x):
    """What a correct reduction over the two blocks would return."""
    n = x.shape[0] // 2
    return x[:n] * 1.0 + x[n:] * 2.0


def race_geometry(n: int = 4):
    """``racy_sum``'s own launch over n outputs: every block writes the
    whole output, a write race."""
    return [KernelGeometry(
        kernel="fixture_race", module=_MODULE, case=f"n{2 * n}",
        grid=GRID,
        inputs=(BlockDecl("x", (2 * n,), (n,), lambda i: (i,)),),
        outputs=(BlockDecl("o", (n,), (n,), lambda i: (0,)),),
    )]


def oob_geometry():
    # blocks of 4 tile an array of extent 10: block 2 spans [8, 12) with no
    # declared mask for the ragged edge
    return [KernelGeometry(
        kernel="fixture_oob", module=_MODULE, case="n10b4",
        grid=(3,),
        inputs=(BlockDecl("x", (10,), (4,), lambda i: (i,)),),
        outputs=(BlockDecl("o", (10,), (4,), lambda i: (i,)),),
    )]


def alias_geometry():
    # input and output share a buffer but declare no alias
    return [KernelGeometry(
        kernel="fixture_alias", module=_MODULE, case="inplace",
        grid=(2,),
        inputs=(BlockDecl("x", (8,), (4,), lambda i: (i,), buffer="state"),),
        outputs=(BlockDecl("o", (8,), (4,), lambda i: (i,), buffer="state"),),
    )]


GEOMETRY_PROVIDERS = {
    "race": race_geometry,
    "oob": oob_geometry,
    "alias": alias_geometry,
}
