"""Dispatching wrapper for the selective scan — the single source of the
backend policy; ``models/ssm.py::mamba1_forward`` sends every scan of a CUDA
tensor through here.

Unlike the JAX package's dispatcher, there is no fallback for a sequence
or channel count that is not a multiple of the block: the CUDA kernel masks
its own ragged edges.
"""

from __future__ import annotations

from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.ssm_scan.ssm_scan import ssm_scan


def ssm_scan_op(u, dt, A, B, C, *, backend: str = "auto"):
    """u, dt: [B,S,di]; A: [di,N]; B, C: [B,S,N] -> y [B,S,di].

    backend: "auto" -> the CUDA kernel for CUDA tensors, the plain PyTorch
    version for CPU tensors; "kernel" -> the CUDA kernel (raises on CPU
    tensors: there is no interpret mode); "ref" -> the plain version on any
    device. A kernel that fails to build or launch raises; nothing falls
    back to the plain version.

    Launches are counted in ``ssm_scan.launches``.
    """
    if backend == "auto":
        backend = "kernel" if u.is_cuda else "ref"
    if backend == "kernel":
        return ssm_scan(u, dt, A, B, C)
    if backend != "ref":
        raise ValueError(f"unknown ssm_scan backend: {backend!r}")
    return ssm_scan_ref(u, dt, A, B, C)
