"""Dispatching wrappers for the fleet's placement kernels — the single
source of the backend policy; the fleet engine routes every placement
attempt (``fused_place_op``) and every HP commit (``fanout_commit_op``)
through here."""

from __future__ import annotations

import torch

from repro_torch.core import tensor_state
from repro_torch.kernels.placement.placement import fanout_commit, fused_place
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


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def fanout_commit_op(t1, t2, valid, min_dur, dev: int, cfg: int, s, e, do,
                     *, backend: str = "auto", counts=None):
    """The §IV.A.1 fan-out commit of ``[s, e)`` on device ``dev`` (an int,
    the same for every row) for a task of config ``cfg``, for the whole
    fleet batch; ``do`` masks the commit per row.

    backend: as ``fused_place_op``'s — "auto" -> the CUDA kernel
    (``placement.fanout_commit``, one launch, in place) for CUDA tensors,
    the plain version (``core/tensor_state.fanout_commit``, new tensors,
    the inputs untouched) for CPU tensors; "kernel" -> the kernel (raises
    on CPU tensors); "ref" -> the plain version on any device.

    Returns ``(t1', t2', valid', n_dropped)``: the plain version's first
    four outputs (its ``time_dropped`` is not computed by the kernel).
    Launches are counted in ``placement.launches_fanout_commit``.
    ``counts``, an int64 ``[2]`` tensor on the windows' device or None,
    gets the rows committed (``do``) and the rows whose windows the commit
    changed (any t1, t2 or valid entry whose bits differ) added to it: by
    the kernel itself, one atomic a block and a counter, and by the plain
    version as two sums.
    """
    if backend == "auto":
        backend = "kernel" if t1.is_cuda else "ref"
    if backend == "kernel":
        return fanout_commit(t1, t2, valid, min_dur, dev, cfg, s, e, do,
                             counts=counts)
    if backend != "ref":
        raise ValueError(f"unknown placement backend: {backend!r}")
    full = lambda x: torch.full(s.shape, x, dtype=torch.int32,
                                device=s.device)
    out = tensor_state.fanout_commit(t1, t2, valid, min_dur, full(dev),
                                     full(cfg), s, e, do)[:4]
    if counts is not None:
        changed = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
        for old, new in zip((t1, t2, valid), out[:3]):
            changed |= (_bits(old) != _bits(new)).flatten(1).any(1)
        counts += torch.stack((do.sum(), changed.sum()))
    return out
