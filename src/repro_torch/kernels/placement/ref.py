"""Plain PyTorch version of the fused placement kernel.

One *placement attempt* of the batched fleet engine — the §IV.B.2
multi-containment query over every device for the preferred (2-core) and
fallback (4-core) LP configs, device selection (source preference, then
earliest start, first index on ties), and the §IV.A.1 multi-remainder
fan-out commit on the winning device — as a single function of the window
tensors. The CUDA kernel (``csrc/placement.cu``) computes the same
function and is held to this one bit for bit; on CPU tensors it is the
only path.
"""

from __future__ import annotations

import torch

from repro_torch.core.tensor_state import BIG, fanout_commit

#: source-device preference margin (seconds) — matches the fleet engine's
#: historical tie-break.
SRC_PREF = 1e-3


def _fused_place_math(t1, t2, valid, min_dur, q1, dl, src, do, *,
                      cfg_pref: int, cfg_fallback: int):
    """Query + select + commit on ``[N, Dev, CFG, T, W]`` window tensors.

    ``min_dur [N, CFG]``; ``q1``/``dl`` ``[N, Dev]`` (comm-adjusted per
    device); ``src`` int ``[N]``; ``do`` bool ``[N]`` masks the attempt.

    Returns ``(t1', t2', valid', ok, sel, start, dur, use4, n_dropped)``
    with per-replica outputs ``[N]``; ``ok`` is already ANDed with ``do``
    and the windows of replicas with ``ok=False`` equal the input.
    """
    N, n_dev = q1.shape
    dev_ids = torch.arange(n_dev, dtype=torch.int32, device=q1.device)
    per_cfg = []
    for ci in (cfg_pref, cfg_fallback):
        dur_c = min_dur[:, ci]                                 # [N]
        tt1 = t1[:, :, ci].reshape(N, n_dev, -1)
        tt2 = t2[:, :, ci].reshape(N, n_dev, -1)
        vv = valid[:, :, ci].reshape(N, n_dev, -1)
        startw = torch.maximum(tt1, q1[:, :, None])
        feas = vv & (
            startw + dur_c[:, None, None]
            <= torch.minimum(tt2, dl[:, :, None])
        )
        best = torch.where(feas, startw, BIG).amin(-1)         # [N, Dev]
        found = best < BIG
        # prefer the source device, then earliest start; first index wins
        # ties (== argmin)
        key = torch.where(found, best, BIG)
        key = key - torch.where(dev_ids[None, :] == src[:, None],
                                SRC_PREF, 0.0)
        kmin = key.amin(1)
        sel_c = torch.where(
            key == kmin[:, None], dev_ids[None, :], n_dev
        ).amin(1)
        sel_oh = dev_ids[None, :] == sel_c[:, None]
        ok_c = (found & sel_oh).any(1)
        # one-hot sum: a single non-zero term, exact in any order
        start_c = torch.where(sel_oh, best, 0.0).sum(1)
        per_cfg.append((ok_c, sel_c, start_c, dur_c))
    (ok2, sel2, start2, dur2), (ok4, sel4, start4, dur4) = per_cfg
    # §IV.B.2: 2-core preferred; widen to 4 cores only when the deadline
    # would otherwise be violated
    use4 = ~ok2 & ok4
    ok = (ok2 | ok4) & do
    sel = torch.where(use4, sel4, sel2)
    start = torch.where(use4, start4, start2)
    dur = torch.where(use4, dur4, dur2)
    cfg_commit = torch.where(
        use4, torch.full_like(sel, cfg_fallback),
        torch.full_like(sel, cfg_pref),
    )
    nt1, nt2, nv, n_drop, _ = fanout_commit(
        t1, t2, valid, min_dur, sel, cfg_commit, start, start + dur, ok,
    )
    return nt1, nt2, nv, ok, sel, start, dur, use4, n_drop


def fused_place_ref(t1, t2, valid, min_dur, q1, dl, src, do, *,
                    cfg_pref: int = 1, cfg_fallback: int = 2):
    """Plain entry point (see ``_fused_place_math`` for shapes). The inputs
    are left untouched; the window outputs are new tensors."""
    return _fused_place_math(
        t1, t2, valid.to(torch.bool), min_dur,
        q1.to(torch.float32), dl.to(torch.float32),
        src.to(torch.int32), do.to(torch.bool),
        cfg_pref=cfg_pref, cfg_fallback=cfg_fallback,
    )
