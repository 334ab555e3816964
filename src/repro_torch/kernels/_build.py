"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel package ``kernels/<name>/csrc/*.cu`` builds into one shared
library with a plain C interface, for Hopper (``sm_90a``), at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xptxas -v -shared -Xcompiler -fPIC -o <lib> <sources>

The library lands in ``kernels/build/`` (git-ignored) under a name that
hashes its sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Only the sources in the package are
compiled. A build that fails raises with nvcc's output; nothing falls back
to the plain version. ``check_tensor`` is the argument check every wrapper
makes before it passes a pointer to its library; ``check_strided`` the one
for a kernel that takes a tensor's strides along with its pointer.

The analysis fixtures' CUDA sources (``SOURCE_DIRS``) build the same way
but live outside ``kernels/``, so that the launch checker's registry, which
walks ``kernels/``, never takes a fixture for a kernel of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "build"
#: source directories of libraries that are not kernel packages
SOURCE_DIRS = {
    "racy_sum": KERNELS_DIR.parent / "analysis" / "fixtures" / "csrc",
}

#: ``--fmad=false``: no multiply-add contraction, so f32 results match the
#: plain PyTorch versions bit for bit. Never ``--use_fast_math``.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def check_tensor(kernel: str, name: str, x, dtype, shape, device) -> None:
    """Raise ``ValueError`` unless ``x`` is a contiguous CUDA tensor of
    ``dtype`` and ``shape`` on ``device``: ctypes passes only its pointer."""
    _check_meta(kernel, name, x, dtype, shape, device)
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def check_strided(kernel: str, name: str, x, dtype, shape, device, *,
                  inner: int) -> None:
    """Raise ``ValueError`` unless ``x`` is a CUDA tensor of ``dtype`` and
    ``shape`` on ``device`` whose last ``inner`` dims are contiguous and
    every element of which lies inside its storage: the kernel gets its
    pointer and its outer strides (torch strides are never negative)."""
    _check_meta(kernel, name, x, dtype, shape, device)
    # one pass over the dims, innermost first: the contiguity of the last
    # ``inner`` and the offset of the last element (a wrapper makes this
    # check on every call, so it stays a plain loop)
    sizes, strides = x.shape, x.stride()
    dims = len(sizes)
    want, last, empty = 1, x.storage_offset(), False
    for i in range(dims - 1, -1, -1):
        n, s = sizes[i], strides[i]
        if i >= dims - inner:
            if n != 1 and s != want:
                raise ValueError(f"{kernel}: the last {inner} dims of "
                                 f"{name} must be contiguous, not strides "
                                 f"{strides}")
            want *= n
        last += (n - 1) * s
        empty = empty or n == 0
    if not empty and last >= (x.untyped_storage().nbytes()
                              // x.element_size()):
        raise ValueError(f"{kernel}: {name}'s strides reach past its "
                         f"storage")


def launch_error(kernel: str, rc: int, error_string,
                 unsupported: str = "unsupported shape") -> RuntimeError:
    """The error of a launch function that returned ``rc`` != 0: -1 for a
    shape its file was not instantiated for, -2 for a grid that is not the
    one its tiling needs, -3 for a TMA tensor map the driver refused, else
    a CUDA error code (``error_string`` is the library's
    ``<kernel>_error_string``)."""
    if rc == -1:
        msg = unsupported
    elif rc == -2:
        msg = "launch grid disagrees with the kernel's tiling"
    elif rc == -3:
        msg = ("the driver refused a TMA tensor map (it takes 16-byte "
               "aligned tensors only)")
    else:
        msg = error_string(rc).decode()
    return RuntimeError(f"{kernel} launch failed ({rc}): {msg}")


def _check_meta(kernel: str, name: str, x, dtype, shape, device) -> None:
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError(f"{kernel}: {name} must be a CUDA tensor")
    if x.device != device:
        raise ValueError(f"{kernel}: {name} is on {x.device}, not {device}")
    if x.dtype != dtype:
        raise ValueError(f"{kernel}: {name} is {x.dtype}, not {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{kernel}: {name} has shape {tuple(x.shape)}, "
                         f"not {shape}")


def _sources(name: str) -> list[Path]:
    root = SOURCE_DIRS.get(name, KERNELS_DIR / name / "csrc")
    srcs = sorted(root.glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources for kernel {name!r}")
    return srcs


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME:
        nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    if nvcc is None or not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, str]:
    """Build every named kernel library that is not built yet, one ``nvcc``
    per library, all started together. Returns nvcc's output (register and
    shared-memory use from ``-Xptxas -v``) by name; raises if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *map(str, _sources(name))]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib
