"""Dispatching wrapper for the SSD scan — the single source of the backend
policy; ``models/ssm.py::mamba2_forward`` sends every scan of a CUDA tensor
through here.

Unlike the JAX package's dispatcher, there is no fallback for a sequence
that is not a multiple of the chunk or a head count that is not a multiple
of the head block: the CUDA kernel takes any S and any H.
"""

from __future__ import annotations

from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan


def ssd_scan_op(x, dt, A, B, C, *, backend: str = "auto"):
    """x: [B,S,H,P]; dt: [B,S,H]; A: [H]; B, C: [B,S,N] -> [B,S,H,P].

    backend: "auto" -> the CUDA kernel for CUDA tensors, the plain PyTorch
    version for CPU tensors; "kernel" -> the CUDA kernel (raises on CPU
    tensors: there is no interpret mode); "ref" -> the plain version on any
    device. A kernel that fails to build or launch raises; nothing falls
    back to the plain version.

    Launches are counted in ``ssd_scan.launches``.
    """
    if backend == "auto":
        backend = "kernel" if x.is_cuda else "ref"
    if backend == "kernel":
        return ssd_scan(x, dt, A, B, C)
    if backend != "ref":
        raise ValueError(f"unknown ssd_scan backend: {backend!r}")
    return ssd_scan_ref(x, dt, A, B, C)
