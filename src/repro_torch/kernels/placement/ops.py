"""Dispatching wrapper for the fused fleet placement — the single source of
the backend policy; the fleet engine routes every placement attempt through
here."""

from __future__ import annotations

import torch

from repro_torch.kernels.placement.placement import fused_place
from repro_torch.kernels.placement.ref import fused_place_ref


def fused_place_op(t1, t2, valid, min_dur, q1, dl, src, do, *,
                   backend: str = "auto", cfg_pref: int = 1,
                   cfg_fallback: int = 2, counts=None):
    """One fused placement attempt for the whole fleet batch.

    backend: "auto" -> the CUDA kernel for CUDA tensors, the plain PyTorch
    version for CPU tensors; "kernel" -> the CUDA kernel (raises on CPU
    tensors: there is no interpret mode); "ref" -> the plain version on
    any device. The kernel commits in place on the window tensors; the
    plain version returns new ones. A kernel that fails to build or launch
    raises; nothing falls back to the plain version.

    Launches are counted in ``placement.launches``. ``counts``, an int64
    ``[2]`` tensor on the windows' device or None, gets the rows attempted
    (``do``) and committed (``ok``) added to it: by the kernel itself, one
    atomic a block and a counter, and by the plain version as two sums.
    """
    if backend == "auto":
        backend = "kernel" if t1.is_cuda else "ref"
    if backend == "kernel":
        return fused_place(
            t1, t2, valid, min_dur, q1, dl, src, do,
            cfg_pref=cfg_pref, cfg_fallback=cfg_fallback, counts=counts,
        )
    if backend != "ref":
        raise ValueError(f"unknown placement backend: {backend!r}")
    out = fused_place_ref(
        t1, t2, valid, min_dur, q1, dl, src, do,
        cfg_pref=cfg_pref, cfg_fallback=cfg_fallback,
    )
    if counts is not None:
        counts += torch.stack((do.sum(), out[3].sum()))
    return out
