"""Plain reference of the batched fleet: the paper's RAS scheduler (§IV)
advanced tick by tick over B independent replicas.

A frozen copy of the port's plain fleet path (``fleet/engine.py`` with the
plain versions of its two kernels, ``fused_place_ref`` and
``window_query_batched_ref``, the fan-out commit and the compaction of
``core/tensor_state.py``, the pristine state of ``fleet/state.py``) and
of the reduction of ``fleet/metrics.py``. It imports nothing of the
program: the benchmark holds the program's output to it, and a later
change to the program leaves it as it is.

It keeps the port's operand order and rounding, so that on one device
it gives the program's counters and state bit for bit:

- overlaps are summed in lane order (``_seq_sum``);
- the tick's time ``f * FRAME_PERIOD`` plus an offset is rounded once
  (``_Clock``);
- no Python scalar is divided by a tensor.

Only what the benchmark's configuration uses is kept: four devices, the
re-queue buffer on (``requeue_slots`` > 0), stagger 1, no telemetry, no
sharding. ``dtype`` is the precision of every time and duration: the
configuration states float32; the control runs the same code in
bfloat16.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FRAME_PERIOD = 18.86
MAX_IMAGE_BYTES = 416 * 416 * 3
LP_PAD_FRACTION = 0.02
DEVICE_CORES = 4
#: (cores, processing time) of the HP, LP2 and LP4 configurations (§V)
CONFIGS = ((2, 0.98), (2, 16.862), (4, 11.611))
HP_IDX, LP2_IDX, LP4_IDX = 0, 1, 2
MAX_LP = 4
BIG = 1e30           # an empty window slot
QUERY_BIG = 3.0e38   # the window query's "nothing found"
SRC_PREF = 1e-3      # source-device preference margin (s)

CFG_CORES = np.array([c for c, _ in CONFIGS], np.int32)
CFG_TRACKS = (DEVICE_CORES // CFG_CORES).astype(np.int32)
#: tracks of list ``l`` a committed task of config ``t`` occupies
OCC_TABLE = np.minimum(
    -(-CFG_CORES[:, None] // CFG_CORES[None, :]), CFG_TRACKS[None, :]
).astype(np.int32)

STATS_FIELDS = (
    "frames", "frames_completed", "hp_completed", "hp_preempted",
    "hp_failed", "lp_spawned", "lp_completed", "lp_failed", "lp_requeued",
    "missed_by_preemption", "lp_offloaded", "lp_four_core",
    "start_delay_sum", "comm_busy", "remainders_dropped",
)
FLOAT_STATS = ("start_delay_sum", "comm_busy")
#: the final state that the benchmark compares, in the program's names
STATE_FIELDS = (
    "win_t1", "win_t2", "win_valid", "link_free", "rq_deadline", "rq_src",
    "rq_valid", "vc_start", "vc_end", "vc_deadline", "vc_src", "vc_valid",
)


class Params(NamedTuple):
    n_devices: int = 4
    nominal_bw_bps: float = 20e6
    transfer_bytes: int = MAX_IMAGE_BYTES
    hp_deadline: float = 3.0
    lp_deadline_factor: float = 1.2
    requeue_slots: int = 4
    compact_every: int = 8
    max_windows: int = 16


def min_durations() -> list[float]:
    """Padded processing time of each configuration (§V)."""
    return [t if i == HP_IDX else t * (1.0 + LP_PAD_FRACTION)
            for i, (_, t) in enumerate(CONFIGS)]


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def pristine(batch: int, p: Params, device, dtype=torch.float32) -> dict:
    """Every device fully available from t = 0: track ``ti`` of a list
    holds one window [0, BIG) where the list has that track."""
    n_cfg, T, W = len(CONFIGS), int(CFG_TRACKS.max()), p.max_windows
    t1 = np.full((p.n_devices, n_cfg, T, W), BIG, np.float32)
    valid = np.zeros(t1.shape, bool)
    for ci, tracks in enumerate(CFG_TRACKS):
        t1[:, ci, :tracks, 0] = 0.0
        valid[:, ci, :tracks, 0] = True
    t2 = np.where(valid, np.float32(BIG), t1).astype(np.float32)

    def tile(x, dt):
        x = torch.from_numpy(x).to(device, dt)
        return x.unsqueeze(0).expand((batch,) + tuple(x.shape)).contiguous()

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    R, D = p.requeue_slots, p.n_devices
    return {
        "win_t1": tile(t1, dtype), "win_t2": tile(t2, dtype),
        "win_valid": tile(valid, torch.bool),
        "min_dur": torch.tensor(min_durations(), dtype=torch.float32)
        .to(device, dtype).expand(batch, n_cfg).contiguous(),
        "link_free": zeros((batch,), dtype),
        "rq_deadline": zeros((batch, R), dtype),
        "rq_src": zeros((batch, R), torch.int32),
        "rq_valid": zeros((batch, R), torch.bool),
        "vc_start": zeros((batch, D), dtype),
        "vc_end": zeros((batch, D), dtype),
        "vc_deadline": zeros((batch, D), dtype),
        "vc_src": zeros((batch, D), torch.int32),
        "vc_valid": zeros((batch, D), torch.bool),
    }


def zero_stats(batch: int, device, dtype=torch.float32) -> dict:
    return {f: torch.zeros((batch,), device=device,
                           dtype=dtype if f in FLOAT_STATS else torch.int32)
            for f in STATS_FIELDS}


# ---------------------------------------------------------------------------
# the §IV.A.1 fan-out commit and compaction
# ---------------------------------------------------------------------------

def _seq_sum(x):
    """Sum over the last axis from lane 0 upward, one add at a time."""
    acc = torch.zeros_like(x[..., 0])
    for w in range(x.shape[-1]):
        acc = acc + x[..., w]
    return acc


def _trim_tracks(t1, t2, valid, s, e, md, active):
    """Multi-remainder trim of ``[s, e)`` from the active tracks' windows;
    a straddle's right piece spills into the first free slot, or is
    counted dropped."""
    W = t1.shape[-1]
    lanes = torch.arange(W, dtype=torch.int32, device=t1.device)
    ov = valid & (t1 < e) & (s < t2) & active
    left_t2 = torch.minimum(t2, s)
    right_t1 = torch.maximum(t1, e)
    left_ok = ov & (left_t2 - t1 >= md)
    right_ok = ov & (t2 - right_t1 >= md)
    both = left_ok & right_ok
    new_valid = torch.where(ov, left_ok | right_ok, valid)
    new_t1 = torch.where(ov & ~left_ok & right_ok, right_t1, t1)
    new_t2 = torch.where(ov & left_ok, left_t2, t2)
    new_t1 = torch.where(new_valid, new_t1, BIG)
    new_t2 = torch.where(new_valid, new_t2, BIG)
    first_free = torch.where(~new_valid, lanes, W).amin(-1, keepdim=True)
    first_both = torch.where(both, lanes, W).amin(-1, keepdim=True)
    placed = (first_both < W) & (first_free < W)
    oh_b = both & (lanes == first_both)
    sp_t1 = torch.where(oh_b, right_t1, 0.0).sum(-1, keepdim=True)
    sp_t2 = torch.where(oh_b, t2, 0.0).sum(-1, keepdim=True)
    place = placed & (lanes == first_free)
    new_t1 = torch.where(place, sp_t1, new_t1)
    new_t2 = torch.where(place, sp_t2, new_t2)
    new_valid = new_valid | place
    dropped = both & ~(placed & (lanes == first_both))
    return new_t1, new_t2, new_valid, dropped.sum(-1, dtype=torch.int32)


def fanout_commit(t1, t2, valid, min_dur, dev, cfg, s, e, do):
    """Consume ``[s, e)`` on device ``dev`` of each row across every
    config list, trimming the ``OCC_TABLE[cfg, ci]`` most-overlapping
    tracks of list ``ci``; rows with ``do`` false are kept as they are.
    Returns ``(t1', t2', valid', n_dropped)``."""
    N, n_dev, n_cfg, T, W = t1.shape
    rows = torch.arange(N, device=t1.device)
    dev = dev.long()
    t1d, t2d, vd = t1[rows, dev], t2[rows, dev], valid[rows, dev]
    sb = s[:, None, None, None]
    eb = e[:, None, None, None]
    ov = vd & (t1d < eb) & (sb < t2d)
    ol = _seq_sum(torch.where(
        ov, torch.minimum(t2d, eb) - torch.maximum(t1d, sb), 0.0))
    track_ids = torch.arange(T, device=t1.device)
    beats = (ol[..., None, :] > ol[..., :, None]) | (
        (ol[..., None, :] == ol[..., :, None])
        & (track_ids[None, :] < track_ids[:, None]))
    rank = beats.sum(-1)
    occ = torch.as_tensor(OCC_TABLE, device=t1.device)[cfg.long()]
    active = do[:, None, None] & (rank < occ[:, :, None]) & (ol > 0.0)
    nt1, nt2, nv, n_drop = _trim_tracks(
        t1d, t2d, vd, sb, eb, min_dur[:, :, None, None], active[..., None])
    dom = do[:, None, None, None]
    out_t1, out_t2, out_valid = t1.clone(), t2.clone(), valid.clone()
    out_t1[rows, dev] = torch.where(dom, nt1, t1d)
    out_t2[rows, dev] = torch.where(dom, nt2, t2d)
    out_valid[rows, dev] = torch.where(dom, nv, vd)
    n_drop = torch.where(do, n_drop.sum((1, 2), dtype=torch.int32), 0)
    return out_t1, out_t2, out_valid, n_drop


def compact_tracks(t1, t2, valid, eps: float = 1e-6):
    """Sort each track's windows by start (stable) and merge abutting
    ones (``next.t1 <= prev.t2 + eps``)."""
    W = t1.shape[-1]
    order = torch.argsort(torch.where(valid, t1, BIG), dim=-1, stable=True)
    t1s = torch.take_along_dim(t1, order, dim=-1)
    t2s = torch.take_along_dim(t2, order, dim=-1)
    vs = torch.take_along_dim(valid, order, dim=-1)
    cmax = torch.cummax(torch.where(vs, t2s, -BIG), dim=-1).values
    prev_end = torch.cat(
        [torch.full_like(cmax[..., :1], -BIG), cmax[..., :-1]], dim=-1)
    starts_seg = vs & (t1s > prev_end + eps)
    seg = torch.cumsum(starts_seg.to(torch.int32), dim=-1) - 1
    lanes = torch.arange(W, device=t1.device)
    member = vs[..., None] & (seg[..., None] == lanes)
    head = starts_seg[..., None] & (seg[..., None] == lanes)
    new_valid = member.any(-2)
    new_t1 = torch.where(
        new_valid, torch.where(head, t1s[..., None], 0.0).sum(-2), BIG)
    new_t2 = torch.where(
        new_valid, torch.where(member, t2s[..., None], -BIG).amax(-2), BIG)
    return new_t1, new_t2, new_valid


# ---------------------------------------------------------------------------
# the two queries: HP containment and the fused LP placement
# ---------------------------------------------------------------------------

def window_query(t1, t2, valid, q1, deadline, dur):
    """[B, Dev, T, W] windows, [B, Dev] parameters -> (found, start):
    the earliest ``dur`` slot in [q1, deadline] of each row."""
    B, Dev = t1.shape[:2]
    q1, deadline, dur = (x.expand(B, Dev)[..., None, None]
                         for x in (q1, deadline, dur))
    start = torch.maximum(t1, q1)
    feasible = valid & (start + dur <= torch.minimum(t2, deadline))
    best = torch.where(feasible, start, QUERY_BIG).reshape(B, Dev, -1)
    best = best.amin(-1)
    return best < QUERY_BIG, best


def fused_place(t1, t2, valid, min_dur, q1, dl, src, do):
    """One LP placement attempt a row (§IV.B.2): the earliest 2-core slot
    over every device, the 4-core one where none fits, the source device
    preferred by SRC_PREF, committed. Returns ``(t1', t2', valid', ok,
    sel, start, dur, use4, n_dropped)``."""
    N, n_dev = q1.shape
    dev_ids = torch.arange(n_dev, dtype=torch.int32, device=q1.device)
    per_cfg = []
    for ci in (LP2_IDX, LP4_IDX):
        dur_c = min_dur[:, ci]
        tt1 = t1[:, :, ci].reshape(N, n_dev, -1)
        tt2 = t2[:, :, ci].reshape(N, n_dev, -1)
        vv = valid[:, :, ci].reshape(N, n_dev, -1)
        startw = torch.maximum(tt1, q1[:, :, None])
        feas = vv & (startw + dur_c[:, None, None]
                     <= torch.minimum(tt2, dl[:, :, None]))
        best = torch.where(feas, startw, BIG).amin(-1)
        found = best < BIG
        key = torch.where(found, best, BIG)
        key = key - torch.where(dev_ids[None, :] == src[:, None],
                                SRC_PREF, 0.0)
        kmin = key.amin(1)
        sel_c = torch.where(
            key == kmin[:, None], dev_ids[None, :], n_dev).amin(1)
        sel_oh = dev_ids[None, :] == sel_c[:, None]
        ok_c = (found & sel_oh).any(1)
        start_c = torch.where(sel_oh, best, 0.0).sum(1)
        per_cfg.append((ok_c, sel_c, start_c, dur_c))
    (ok2, sel2, start2, dur2), (ok4, sel4, start4, dur4) = per_cfg
    use4 = ~ok2 & ok4
    ok = (ok2 | ok4) & do
    sel = torch.where(use4, sel4, sel2)
    start = torch.where(use4, start4, start2)
    dur = torch.where(use4, dur4, dur2)
    cfg = torch.where(use4, torch.full_like(sel, LP4_IDX),
                      torch.full_like(sel, LP2_IDX))
    nt1, nt2, nv, n_drop = fanout_commit(
        t1, t2, valid, min_dur, sel, cfg, start, start + dur, ok)
    return nt1, nt2, nv, ok, sel, start, dur, use4, n_drop


# ---------------------------------------------------------------------------
# one frame tick
# ---------------------------------------------------------------------------

class _Clock:
    """``base = f32(f) * FRAME_PERIOD``; ``plus(x)`` is the exact ``f *
    FRAME_PERIOD + x`` rounded once to the time precision."""

    def __init__(self, f: int, dtype):
        self.dtype = dtype
        self.prod = f * torch.tensor(FRAME_PERIOD, dtype=torch.float32).item()
        self.base = (torch.tensor(f, dtype=torch.float32)
                     * FRAME_PERIOD).to(dtype)

    def plus(self, x):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(x, dtype=torch.float32).to(self.dtype)
        return (x.to(torch.float64) + self.prod).to(self.dtype)


def _vc_commit(st, ok, sel, start, end, deadline, src):
    """Record a committed LP placement in the per-device victim cache."""
    n_dev = st["vc_end"].shape[1]
    hit = ok[:, None] & (
        torch.arange(n_dev, dtype=torch.int32, device=ok.device)[None, :]
        == sel[:, None])
    for k, x in (("vc_start", start), ("vc_end", end),
                 ("vc_deadline", deadline), ("vc_src", src)):
        st[k] = torch.where(hit, x[:, None], st[k])
    st["vc_valid"] = st["vc_valid"] | hit


def _place(st, q1, dl, src, do):
    t1, t2, valid, ok, sel, start, dur, use4, nd = fused_place(
        st["win_t1"], st["win_t2"], st["win_valid"], st["min_dur"],
        q1.contiguous(), dl.contiguous(), src.contiguous(), do.contiguous())
    st.update(win_t1=t1, win_t2=t2, win_valid=valid)
    return ok, sel, start, dur, use4, nd


def frame_step(st: dict, stats: dict, f: int, v, bws, p: Params) -> None:
    """Advance every row by tick ``f``: housekeeping (and compaction every
    ``compact_every`` ticks), one re-queue attempt, then per device the HP
    query and commit, the immediate re-placement of an evicted victim and
    up to four LP placements. ``st`` and ``stats`` are updated in place."""
    B = st["link_free"].shape[0]
    n_dev, R = p.n_devices, p.requeue_slots
    device = st["link_free"].device
    fdt = st["link_free"].dtype
    dev_ids = torch.arange(n_dev, dtype=torch.int32, device=device)
    rows = torch.arange(B, device=device)
    clock = _Clock(f, fdt)
    base = clock.base
    st["win_valid"] = st["win_valid"] & (st["win_t2"] > base)
    if p.compact_every > 0 and f % p.compact_every == p.compact_every - 1:
        st["win_t1"], st["win_t2"], st["win_valid"] = compact_tracks(
            st["win_t1"], st["win_t2"], st["win_valid"])
    ttime = torch.full_like(bws, p.transfer_bytes * 8.0) / (
        p.nominal_bw_bps * torch.clamp(bws, min=1e-3))

    def add(**kw):
        for k, x in kw.items():
            stats[k] = stats[k] + x

    # the victim re-queue pass (§IV.B.3)
    now0 = torch.zeros((B,), dtype=fdt, device=device) + base
    min_dur = st["min_dur"]
    min_lp = torch.minimum(min_dur[:, LP2_IDX], min_dur[:, LP4_IDX])
    rq_dl, rq_src, rq_ok = st["rq_deadline"], st["rq_src"], st["rq_valid"]
    expired = rq_ok & (clock.plus(min_lp)[:, None] > rq_dl)
    rq_ok = rq_ok & ~expired
    add(missed_by_preemption=expired.sum(1, dtype=torch.int32))
    slot = torch.where(rq_ok, rq_dl, BIG).argmin(1)
    valid_r = rq_ok[rows, slot]
    dl = rq_dl[rows, slot]
    src = rq_src[rows, slot]
    comm_end = torch.maximum(st["link_free"], now0) + ttime
    q1 = torch.where(dev_ids[None, :] == src[:, None], now0[:, None],
                     torch.maximum(now0, comm_end)[:, None])
    ok, sel, start, dur, use4, nd = _place(
        st, q1, dl[:, None].expand(B, n_dev), src, valid_r)
    offl = ok & (sel != src)
    st["link_free"] = torch.where(offl, comm_end, st["link_free"])
    _vc_commit(st, ok, sel, start, start + dur, dl, src)
    add(lp_completed=ok, lp_requeued=ok, lp_offloaded=offl,
        lp_four_core=ok & use4, comm_busy=torch.where(offl, ttime, 0.0),
        remainders_dropped=nd)
    rq_ok = rq_ok.clone()
    rq_ok[rows, slot] = valid_r & ~ok

    for d in range(n_dev):
        c_rel = d * (FRAME_PERIOD / n_dev)
        t_rel = base if d == 0 else clock.plus(c_rel)
        now = torch.zeros((B,), dtype=fdt, device=device) + t_rel
        now_plus = clock.plus if d == 0 else (lambda x: now + x)
        vd = v[:, d].to(torch.int32)
        has_frame = vd >= 0

        # HP: an immediate slot on the source device
        hp_dur = min_dur[:, HP_IDX]
        hp_dl = now_plus(torch.clamp(hp_dur + 1e-6, min=p.hp_deadline))
        dsl = slice(d, d + 1)
        hp_found, hp_start = window_query(
            st["win_t1"][:, dsl, HP_IDX], st["win_t2"][:, dsl, HP_IDX],
            st["win_valid"][:, dsl, HP_IDX], now[:, None], hp_dl[:, None],
            hp_dur[:, None])
        hp_found, hp_start = hp_found[:, 0], hp_start[:, 0]
        victim_live = (st["vc_valid"][:, d] & (st["vc_end"][:, d] > now)
                       & (st["vc_start"][:, d] < now_plus(hp_dur)))
        hp_ok = has_frame & (hp_found | victim_live)
        preempt = has_frame & ~hp_found & victim_live
        hp_fail = has_frame & ~hp_found & ~victim_live
        hp_start = torch.where(hp_found, hp_start, now)
        t1, t2, valid, nd = fanout_commit(
            st["win_t1"], st["win_t2"], st["win_valid"], min_dur,
            torch.full((B,), d, dtype=torch.int32, device=device),
            torch.full((B,), HP_IDX, dtype=torch.int32, device=device),
            hp_start, hp_start + hp_dur, hp_ok)
        st.update(win_t1=t1, win_t2=t2, win_valid=valid)
        add(remainders_dropped=nd)

        # eviction: the victim's credit is revoked, then re-placed at once
        vc_ok = st["vc_valid"].clone()
        vc_ok[:, d] = vc_ok[:, d] & ~preempt
        st["vc_valid"] = vc_ok
        add(lp_completed=-preempt.to(torch.int32))
        dl_v = st["vc_deadline"][:, d]
        src_v = st["vc_src"][:, d]
        comm_end = torch.maximum(st["link_free"], now) + ttime
        q1 = torch.where(dev_ids[None, :] == src_v[:, None], now[:, None],
                         torch.maximum(now, comm_end)[:, None])
        ok_v, sel_v, start_v, dur_v, use4_v, nd = _place(
            st, q1, dl_v[:, None].expand(B, n_dev), src_v, preempt)
        offl_v = ok_v & (sel_v != src_v)
        st["link_free"] = torch.where(offl_v, comm_end, st["link_free"])
        _vc_commit(st, ok_v, sel_v, start_v, start_v + dur_v, dl_v, src_v)
        add(lp_completed=ok_v, lp_requeued=ok_v, lp_offloaded=offl_v,
            lp_four_core=ok_v & use4_v,
            comm_busy=torch.where(offl_v, ttime, 0.0),
            remainders_dropped=nd)

        # an unplaced victim enters the re-queue buffer, or is missed
        free = rq_ok.to(torch.int32).argmin(1)
        has_free = ~rq_ok.all(1)
        unplaced = preempt & ~ok_v
        push = unplaced & has_free
        rq_dl, rq_src, rq_ok = rq_dl.clone(), rq_src.clone(), rq_ok.clone()
        rq_dl[rows, free] = torch.where(push, dl_v, rq_dl[rows, free])
        rq_src[rows, free] = torch.where(push, src_v, rq_src[rows, free])
        rq_ok[rows, free] = rq_ok[rows, free] | push
        add(missed_by_preemption=unplaced & ~has_free)
        add(frames=has_frame, hp_completed=hp_ok, hp_failed=hp_fail,
            hp_preempted=preempt)

        # LP: up to four DNN tasks once HP completes
        n_lp = torch.where(hp_ok, torch.clamp(vd, 0, MAX_LP), 0)
        release = hp_start + hp_dur
        c_dl = (torch.tensor(c_rel, dtype=torch.float32)
                + torch.tensor(p.lp_deadline_factor * FRAME_PERIOD,
                               dtype=torch.float32))
        deadline = (torch.zeros((B,), dtype=fdt, device=device)
                    + clock.plus(c_dl.to(fdt)))
        frame_ok = hp_ok
        src_d = torch.full((B,), d, dtype=torch.int32, device=device)
        dl = deadline[:, None].expand(B, n_dev)
        for k in range(MAX_LP):
            mask = hp_ok & (k < n_lp)
            comm_end = torch.maximum(st["link_free"], release) + ttime
            q1 = torch.where(dev_ids[None, :] == d, release[:, None],
                             torch.maximum(release, comm_end)[:, None])
            ok, sel, start, dur, use4, nd = _place(st, q1, dl, src_d, mask)
            offl = ok & (sel != d)
            st["link_free"] = torch.where(offl, comm_end, st["link_free"])
            _vc_commit(st, ok, sel, start, start + dur, deadline, src_d)
            add(lp_spawned=mask, lp_completed=ok, lp_failed=mask & ~ok,
                lp_offloaded=offl, lp_four_core=ok & use4,
                start_delay_sum=torch.where(ok, start - release, 0.0),
                comm_busy=torch.where(offl, ttime, 0.0),
                remainders_dropped=nd)
            frame_ok = frame_ok & (ok | (k >= n_lp))
        add(frames_completed=has_frame & frame_ok)
    st.update(rq_deadline=rq_dl, rq_src=rq_src, rq_valid=rq_ok)


def run(values, bw_scale, p: Params, *, device, dtype=torch.float32):
    """Advance a pristine fleet of B rows over ``values`` ([F, B, Dev]
    workload) and ``bw_scale`` ([F, B]). Returns ``(state, stats)``:
    dicts of tensors in the program's names."""
    values = torch.as_tensor(values).to(device, torch.int32)
    bw_scale = torch.as_tensor(bw_scale).to(device, dtype)
    F, B = values.shape[:2]
    if p.requeue_slots < 1:
        raise ValueError("the reference keeps the re-queue buffer on only")
    st = pristine(B, p, device, dtype)
    stats = zero_stats(B, device, dtype)
    for f in range(F):
        frame_step(st, stats, f, values[f], bw_scale[f], p)
    return st, stats


# ---------------------------------------------------------------------------
# the per-batch reduction (``fleet/metrics.py::summarize``)
# ---------------------------------------------------------------------------

def _mean_ci(x) -> dict:
    x = np.asarray(x, np.float64)
    n = x.size
    mean = float(x.mean()) if n else 0.0
    ci = float(1.96 * x.std(ddof=1) / np.sqrt(n)) if n > 1 else 0.0
    return {"mean": round(mean, 4), "ci95": round(ci, 4)}


def residual(stats: dict, rq_pending) -> np.ndarray:
    """Per-row residual of the LP-task conservation identity: every
    spawned LP task is completed, failed, missed or still re-queued."""
    s = {k: np.asarray(stats[k]).astype(np.int64) for k in (
        "lp_spawned", "lp_completed", "lp_failed", "missed_by_preemption")}
    return s["lp_spawned"] - (s["lp_completed"] + s["lp_failed"]
                              + s["missed_by_preemption"]
                              + np.asarray(rq_pending).astype(np.int64))


def summarize(stats: dict, n_frames: int, rq_pending) -> dict:
    """Mean and 95% CI over rows of each rate, from host counters."""
    s = {k: np.asarray(v).astype(np.float64) for k, v in stats.items()}
    frames = np.clip(s["frames"], 1, None)
    lp = np.clip(s["lp_spawned"], 1, None)
    placed = np.clip(s["lp_completed"] + s["hp_preempted"], 1, None)
    victims = np.clip(s["hp_preempted"], 1, None)
    initial = np.clip(
        s["lp_completed"] + s["hp_preempted"] - s["lp_requeued"], 1, None)
    rates = {
        "frame_completion_rate": s["frames_completed"] / frames,
        "hp_completion_rate": s["hp_completed"] / frames,
        "hp_preemption_rate": s["hp_preempted"] / frames,
        "hp_failure_rate": s["hp_failed"] / frames,
        "lp_completion_rate": s["lp_completed"] / lp,
        "lp_violation_rate": s["lp_failed"] / lp,
        "requeue_success_rate": s["lp_requeued"] / victims,
        "missed_by_preemption_rate": s["missed_by_preemption"] / lp,
        "lp_offload_fraction": s["lp_offloaded"] / placed,
        "four_core_fraction": s["lp_four_core"] / placed,
        "mean_start_delay_s": s["start_delay_sum"] / initial,
        "remainder_drop_rate": s["remainders_dropped"] / frames,
        "rq_pending_depth": np.asarray(rq_pending).astype(np.float64),
    }
    raw = {k: np.asarray(v) for k, v in stats.items()}
    sim_time = n_frames * FRAME_PERIOD
    out = {"replicas": int(raw["frames"].size)}
    out.update((k, _mean_ci(v)) for k, v in rates.items())
    out["link_utilisation"] = _mean_ci(raw["comm_busy"] / sim_time)
    out["lp_throughput_per_s"] = _mean_ci(raw["lp_completed"] / sim_time)
    res = residual(stats, rq_pending)
    out["conservation_residual"] = {
        **_mean_ci(res), "max_abs": int(np.abs(res).max()) if res.size else 0}
    return out
