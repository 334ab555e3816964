"""Batched fixed-step fleet simulator: B replicas advanced together.

Counterpart of ``repro/fleet/engine.py``; see there for the model and its
fidelity contract. A Python loop over frame ticks advances every replica
of a Monte-Carlo fleet at once, with the per-tick pipeline

    housekeeping (+ compaction every ``compact_every`` ticks)
      → victim re-queue attempt
      → per device: HP query, HP fan-out commit, immediate re-placement
        of a preempted victim, up to 4 LP placement attempts
      → accounting

Every placement attempt is one call of ``fused_place_op``: on CUDA tensors
one launch of the CUDA fused placement kernel for the whole fleet, 21 a
tick with the re-queue buffer on (1 + 4·(1 + 4)), whatever the data, since
each attempt is masked per replica and never skipped. Each device's HP
query is one call of ``window_query_batched_op``, and its HP commit one
call of ``fanout_commit_op`` (the CUDA fan-out commit kernel, in place):
4 launches of each a tick, 29 kernel launches a tick in all. Compaction
and the bookkeeping are plain PyTorch.

With ``telemetry`` on, each kept tick also captures the series of
``obs/telemetry.py`` from the end-of-tick carry (read-only, ~120 small
ops); with ``mesh_shards >= 1`` the batch is split across devices
(``fleet/mesh.py``) and the shards advance tick by tick in turn. Under
an active ``obs/profile.py`` timer each tick and its phases run in spans,
and a device-timed timer also gets ``fused_place``'s attempt counters and
the HP commit's counters (``fleet_run``).

Every expression keeps the JAX package's operand order and dtypes, so a
CPU run reproduces it bit for bit. Three rules make that hold:

- no Python scalar is divided by a tensor (``scalar / tensor`` is a
  reciprocal times the scalar in torch);
- overlaps are summed in lane order (``core/tensor_state._seq_sum``);
- the tick's time ``base = f32(f) * FRAME_PERIOD`` followed by an add is
  rounded once, as a fused multiply-add (``_Clock``): XLA compiles the
  reference for the host that way, and folds ``base + c1 + c2`` into
  ``base + (c1 + c2)`` first. Rounding the product before the add differs
  in the last bit now and then, and a deadline a bit off changes a
  placement.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.core.tasks import FRAME_PERIOD, MAX_IMAGE_BYTES
from repro_torch.core.tensor_state import (
    BIG, SchedState, compact_state,
)
from repro_torch.fleet import mesh as _mesh
from repro_torch.fleet.metrics import init_stats
from repro_torch.fleet.state import FleetState
from repro_torch.kernels.placement.ops import fanout_commit_op, fused_place_op
from repro_torch.kernels.window_query.ops import window_query_batched_op
from repro_torch.obs import profile as _profile
from repro_torch.obs import telemetry as _telemetry

HP_IDX, LP2_IDX, LP4_IDX = 0, 1, 2
MAX_LP = 4   # trace alphabet spawns at most 4 DNN tasks per frame


@dataclasses.dataclass(frozen=True)
class FleetParams:
    """Knobs of the batched engine (the JAX package's fields and defaults)."""

    n_devices: int = 4
    nominal_bw_bps: float = 20e6
    transfer_bytes: int = MAX_IMAGE_BYTES
    hp_deadline: float = 3.0
    lp_deadline_factor: float = 1.2
    stagger: float = 1.0
    #: backend of the fleet's kernels, fused_place_op, the HP query's
    #: window_query_batched_op and the HP commit's fanout_commit_op:
    #: "auto" | "kernel" | "ref".
    placement_backend: str = "auto"
    #: the Pallas kernel's replica tile; the CUDA kernel's block is fixed
    #: at 128 replicas and does not read it.
    placement_block_b: int = 8
    #: split the batch across this many devices (``fleet/mesh.py``): 0
    #: runs unsharded; 1 runs the sharded code path on one device. B is
    #: padded up to a multiple of the shard count with no-op replicas,
    #: trimmed from every output, so results are bit-identical to the
    #: unsharded engine.
    mesh_shards: int = 0
    #: width of the per-replica victim re-queue buffer (0 disables the
    #: reallocation pass and reverts to capacity-eviction-only preemption).
    requeue_slots: int = 4
    #: merge abutting windows per track every this many ticks (0 disables).
    compact_every: int = 8
    #: ticks per segment of the tick loop (0 -> one segment). The result
    #: does not depend on it.
    segment_frames: int = 40
    #: opt-in in-loop telemetry (``obs/telemetry.py``): ``fleet_run``
    #: returns a third value, a TelemetryRecord of per-tick series. The
    #: capture is read-only: state and stats stay bit-identical.
    telemetry: bool = False
    #: keep every k-th tick of the telemetry series (ticks 0, k, 2k, ...).
    telemetry_every: int = 1


class _Clock:
    """Times of tick ``f`` as the reference rounds them: ``base`` is
    ``f32(f) * f32(FRAME_PERIOD)``, and ``base + x`` is the exact
    ``f * FRAME_PERIOD + x`` rounded once to f32 (a fused multiply-add).
    The sum is exact in float64: the product has at most 31 significant
    bits, and x is an f32 of comparable size."""

    def __init__(self, f: int):
        self.prod = f * torch.tensor(FRAME_PERIOD, dtype=torch.float32).item()
        self.base = torch.tensor(f, dtype=torch.float32) * FRAME_PERIOD

    def plus(self, x):
        """``base + x`` for a tensor ``x``, or a Python float taken as f32."""
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(x, dtype=torch.float32)
        return (x.to(torch.float64) + self.prod).to(torch.float32)


def _hp_query(st: SchedState, dev: int, now, dur, deadline,
              backend: str = "auto"):
    """HP containment query on one device: a `dur` slot starting in
    [now, deadline - dur] (§IV.B.1), with ``deadline = now +
    max(hp_deadline, dur + 1e-6)`` computed by the caller.

    One batched window query over the [B, 1, T, W] view of the device's HP
    list, read in place. Where nothing is found, ``start`` is the window
    query's BIG (3e38), not ``tensor_state.BIG`` (1e30) as in the JAX
    package: the caller reads ``start`` only where ``found`` holds."""
    d = slice(dev, dev + 1)
    found, start = window_query_batched_op(
        st.win_t1[:, d, HP_IDX], st.win_t2[:, d, HP_IDX],
        st.win_valid[:, d, HP_IDX], now[:, None], deadline[:, None],
        dur[:, None], backend=backend,
    )
    return found[:, 0].bool(), start[:, 0]


def _hp_commit(st: SchedState, dev: int, s, e, do, backend: str = "auto",
               counts=None):
    """§IV.A.1 fan-out commit of an HP slot on device `dev`, per replica,
    through ``fanout_commit_op`` (on CUDA tensors one launch of the fan-out
    commit kernel, in place). ``counts``, device ``dev``'s row of the
    [Dev, 2] HP commit counters or None, gets the rows committed and the
    rows whose windows changed added to it.
    Returns (state', n_dropped[B])."""
    t1, t2, valid, n_drop = fanout_commit_op(
        st.win_t1, st.win_t2, st.win_valid, st.min_dur, dev, HP_IDX,
        s, e, do, backend=backend, counts=counts,
    )
    return st._replace(win_t1=t1, win_t2=t2, win_valid=valid), n_drop


def _place_lp(st: SchedState, q1, dl, src, do, p: FleetParams,
              counts=None, slot: int = 0):
    """One batched §IV.B.2 placement attempt through the fused kernel:
    2-core preferred, 4-core fallback, source-device preference, earliest
    start, committed in the same launch. ``q1``/``dl`` are [B, Dev],
    ``src`` the [B] source device, ``do`` masks the attempt per replica.
    ``counts``, the [n_slots, 2] attempt counters or None, gets the rows
    attempted and committed added to row ``slot``.
    Returns (state', ok, sel, start, dur, use4, n_dropped); windows of
    replicas with ``ok=False`` are untouched."""
    t1, t2, valid, ok, sel, start, dur, use4, n_drop = fused_place_op(
        st.win_t1, st.win_t2, st.win_valid, st.min_dur,
        q1.contiguous(), dl.contiguous(), src.contiguous(), do.contiguous(),
        backend=p.placement_backend, cfg_pref=LP2_IDX, cfg_fallback=LP4_IDX,
        counts=None if counts is None else counts[slot],
    )
    st = st._replace(win_t1=t1, win_t2=t2, win_valid=valid)
    return st, ok, sel, start, dur, use4, n_drop


def _vc_commit(vc, ok, sel, start, end, deadline, src):
    """Record a committed LP placement in the per-device victim cache."""
    vc_s, vc_end, vc_dl, vc_src, vc_ok = vc
    n_dev = vc_end.shape[1]
    hit = ok[:, None] & (
        torch.arange(n_dev, dtype=torch.int32, device=ok.device)[None, :]
        == sel[:, None]
    )
    return (
        torch.where(hit, start[:, None], vc_s),
        torch.where(hit, end[:, None], vc_end),
        torch.where(hit, deadline[:, None], vc_dl),
        torch.where(hit, src[:, None], vc_src),
        vc_ok | hit,
    )


def _i32(x):
    return x.to(torch.int32)


def _frame_step(carry, f: int, v, bws, p: FleetParams,
                capture: bool = False, counts=None, hp_counts=None):
    """Advance every replica by one frame tick ``f`` (a host int); ``v`` is
    the [B, Dev] workload of the tick, ``bws`` the [B] bandwidth scale.
    ``counts`` (or None) is the [1 + Dev·(1 + MAX_LP), 2] buffer of
    ``fused_place``'s rows attempted and committed per attempt slot: 0 the
    re-queue pass, 1 + d device d's victim re-placement, 1 + Dev + d·MAX_LP
    + k its LP attempt k; ``hp_counts`` (or None) the [Dev, 2] buffer of
    each device's HP commits: rows committed, rows whose windows changed.
    Returns the new carry and, with ``capture``, the tick's
    ``TelemetryFrame`` (else None).

    The phases run in spans (``obs/profile.py``) inside the caller's
    ``fleet/tick``: ``fleet/compaction``, ``fleet/requeue`` (the pass at
    the tick's start, and each device's victim re-placement and buffer
    push), ``fleet/hp`` (each device's HP query, fan-out commit and its
    drop count) and ``fleet/lp`` (each device's LP attempts and
    ``frames_completed``); the housekeeping, the transfer time and the
    other accounting lines are the tick's own time."""
    st, link_free, (rq_dl, rq_src, rq_ok), vc, stats = carry
    stats0 = stats
    if capture:
        # per-device decision counts, stacked to [B, Dev] at capture time
        pd_run, pd_fail, pd_preempt, pd_lp = [], [], [], []
    vc_s, vc_end, vc_dl, vc_src, vc_ok = vc
    B = link_free.shape[0]
    n_dev = p.n_devices
    R = p.requeue_slots
    device = link_free.device
    dev_ids = torch.arange(n_dev, dtype=torch.int32, device=device)
    rows = torch.arange(B, device=device)

    # 0-d host tensors, read as scalars by the device ops below
    clock = _Clock(f)
    base = clock.base
    # housekeeping: recycle slots of fully-elapsed windows
    st = st._replace(win_valid=st.win_valid & (st.win_t2 > base))
    if p.compact_every > 0 and f % p.compact_every == p.compact_every - 1:
        with _profile.span("fleet/compaction"):
            st = compact_state(st)

    # a float32 tensor over a tensor: a Python scalar over a tensor is a
    # reciprocal times the scalar in torch, and can differ in the last bit
    ttime = torch.full_like(bws, p.transfer_bytes * 8.0) / (
        p.nominal_bw_bps * torch.clamp(bws, min=1e-3)
    )

    # -- victim re-queue pass (§IV.B.3 reallocation) ------------------------
    now0 = torch.zeros((B,), dtype=torch.float32, device=device) + base
    min_lp_dur = torch.minimum(st.min_dur[:, LP2_IDX], st.min_dur[:, LP4_IDX])
    if R > 0:
        with _profile.span("fleet/requeue"):
            expired = rq_ok & (clock.plus(min_lp_dur)[:, None] > rq_dl)
            rq_ok = rq_ok & ~expired
            stats = stats._replace(
                missed_by_preemption=stats.missed_by_preemption
                + expired.sum(1, dtype=torch.int32)
            )
            # one placement attempt per tick for the earliest-deadline
            # survivor
            slot = torch.where(rq_ok, rq_dl, BIG).argmin(1)
            valid_r = rq_ok[rows, slot]
            dl = rq_dl[rows, slot]
            src = rq_src[rows, slot]
            comm_end = torch.maximum(link_free, now0) + ttime
            q1 = torch.where(
                dev_ids[None, :] == src[:, None], now0[:, None],
                torch.maximum(now0, comm_end)[:, None],
            )
            dlb = dl[:, None].expand(B, n_dev)
            st, ok, sel, start, dur, use4, nd = _place_lp(
                st, q1, dlb, src, valid_r, p, counts, 0
            )
            offl = ok & (sel != src)
            link_free = torch.where(offl, comm_end, link_free)
            # the re-placed victim is now the newest commit on its device
            vc_s, vc_end, vc_dl, vc_src, vc_ok = _vc_commit(
                (vc_s, vc_end, vc_dl, vc_src, vc_ok), ok, sel, start,
                start + dur, dl, src
            )
            stats = stats._replace(
                lp_completed=stats.lp_completed + ok,
                lp_requeued=stats.lp_requeued + ok,
                lp_offloaded=stats.lp_offloaded + offl,
                lp_four_core=stats.lp_four_core + (ok & use4),
                comm_busy=stats.comm_busy + torch.where(offl, ttime, 0.0),
                remainders_dropped=stats.remainders_dropped + nd,
            )
            rq_ok = rq_ok.clone()
            rq_ok[rows, slot] = valid_r & ~ok

    for d in range(n_dev):
        c_rel = d * (FRAME_PERIOD / n_dev) * p.stagger
        # base + 0.0 is base itself; after it, now + x rounds twice
        t_rel = base if d == 0 else clock.plus(c_rel)
        now = torch.zeros((B,), dtype=torch.float32, device=device) + t_rel
        now_plus = clock.plus if d == 0 else (lambda x: now + x)
        vd = _i32(v[:, d])
        has_frame = vd >= 0

        # -- HP: immediate slot on the source device ------------------------
        with _profile.span("fleet/hp"):
            hp_dur = st.min_dur[:, HP_IDX]
            hp_found, hp_start = _hp_query(
                st, d, now, hp_dur,
                now_plus(torch.clamp(hp_dur + 1e-6, min=p.hp_deadline)),
                p.placement_backend,
            )
            if R > 0:
                # the serial engine evicts only a task whose reserved slot
                # overlaps the requested HP window (§IV.B.3)
                victim_live = (vc_ok[:, d] & (vc_end[:, d] > now)
                               & (vc_s[:, d] < now_plus(hp_dur)))
            else:
                # reallocation disabled: capacity-eviction semantics
                victim_live = torch.ones((B,), dtype=torch.bool,
                                         device=device)
            hp_ok = has_frame & (hp_found | victim_live)
            preempt = has_frame & ~hp_found & victim_live
            hp_fail = has_frame & ~hp_found & ~victim_live
            # where nothing was found hp_start is the query's BIG; it is
            # replaced here, before any use
            hp_start = torch.where(hp_found, hp_start, now)
            st, nd = _hp_commit(
                st, d, hp_start, hp_start + hp_dur, hp_ok,
                p.placement_backend,
                None if hp_counts is None else hp_counts[d])
            stats = stats._replace(
                remainders_dropped=stats.remainders_dropped + nd
            )

        if R > 0:
            with _profile.span("fleet/requeue"):
                vc_ok = vc_ok.clone()
                vc_ok[:, d] = vc_ok[:, d] & ~preempt
                # the victim's placement-time completion credit is revoked
                stats = stats._replace(
                    lp_completed=stats.lp_completed - _i32(preempt)
                )

                # immediate reallocation attempt (§VI.A)
                dl_v = vc_dl[:, d]
                src_v = vc_src[:, d]
                comm_end = torch.maximum(link_free, now) + ttime
                q1 = torch.where(
                    dev_ids[None, :] == src_v[:, None], now[:, None],
                    torch.maximum(now, comm_end)[:, None],
                )
                st, ok_v, sel_v, start_v, dur_v, use4_v, nd = _place_lp(
                    st, q1, dl_v[:, None].expand(B, n_dev), src_v, preempt,
                    p, counts, 1 + d,
                )
                offl_v = ok_v & (sel_v != src_v)
                link_free = torch.where(offl_v, comm_end, link_free)
                vc_s, vc_end, vc_dl, vc_src, vc_ok = _vc_commit(
                    (vc_s, vc_end, vc_dl, vc_src, vc_ok), ok_v, sel_v,
                    start_v, start_v + dur_v, dl_v, src_v,
                )
                stats = stats._replace(
                    lp_completed=stats.lp_completed + ok_v,
                    lp_requeued=stats.lp_requeued + ok_v,
                    lp_offloaded=stats.lp_offloaded + offl_v,
                    lp_four_core=stats.lp_four_core + (ok_v & use4_v),
                    comm_busy=stats.comm_busy
                    + torch.where(offl_v, ttime, 0.0),
                    remainders_dropped=stats.remainders_dropped + nd,
                )

                # unplaced victims enter the bounded re-queue buffer; a
                # full buffer drops the victim (counted missed, not silent)
                free = _i32(rq_ok).argmin(1)
                has_free = ~rq_ok.all(1)
                unplaced = preempt & ~ok_v
                push = unplaced & has_free
                rq_dl = rq_dl.clone()
                rq_src = rq_src.clone()
                rq_ok = rq_ok.clone()
                rq_dl[rows, free] = torch.where(push, dl_v,
                                                rq_dl[rows, free])
                rq_src[rows, free] = torch.where(push, src_v,
                                                 rq_src[rows, free])
                rq_ok[rows, free] = rq_ok[rows, free] | push
                stats = stats._replace(
                    missed_by_preemption=stats.missed_by_preemption
                    + (unplaced & ~has_free),
                )

        stats = stats._replace(
            frames=stats.frames + has_frame,
            hp_completed=stats.hp_completed + hp_ok,
            hp_failed=stats.hp_failed + hp_fail,
            hp_preempted=stats.hp_preempted + preempt,
        )

        # -- LP: up to 4 DNN tasks once HP completes -------------------------
        with _profile.span("fleet/lp"):
            n_lp = torch.where(hp_ok, torch.clamp(vd, 0, MAX_LP), 0)
            release = hp_start + hp_dur
            # now + c_dl is base + (c_rel + c_dl), the constants summed in
            # f32
            c_dl = (torch.tensor(c_rel, dtype=torch.float32)
                    + torch.tensor(p.lp_deadline_factor * FRAME_PERIOD,
                                   dtype=torch.float32))
            deadline = (torch.zeros((B,), dtype=torch.float32, device=device)
                        + clock.plus(c_dl))
            # without re-queue (R=0) the victim cache is written and never
            # read, and XLA rounds the copy it stores in two steps,
            # base + c_dl
            vc_deadline = deadline if R > 0 else (
                torch.zeros((B,), dtype=torch.float32, device=device)
                + (base + c_dl))
            frame_ok = hp_ok
            src_d = torch.full((B,), d, dtype=torch.int32, device=device)
            dl = deadline[:, None].expand(B, n_dev)
            if capture:
                lp_placed_d = torch.zeros((B,), dtype=torch.int32,
                                          device=device)
            for k in range(MAX_LP):
                mask = hp_ok & (k < n_lp)
                comm_end = torch.maximum(link_free, release) + ttime
                # remote devices can only start once their transfer lands
                q1 = torch.where(
                    dev_ids[None, :] == d, release[:, None],
                    torch.maximum(release, comm_end)[:, None],
                )
                st, ok, sel, start, dur, use4, nd = _place_lp(
                    st, q1, dl, src_d, mask, p, counts,
                    1 + n_dev + d * MAX_LP + k,
                )
                offl = ok & (sel != d)
                link_free = torch.where(offl, comm_end, link_free)
                vc_s, vc_end, vc_dl, vc_src, vc_ok = _vc_commit(
                    (vc_s, vc_end, vc_dl, vc_src, vc_ok), ok, sel, start,
                    start + dur, vc_deadline, src_d,
                )
                stats = stats._replace(
                    lp_spawned=stats.lp_spawned + mask,
                    lp_completed=stats.lp_completed + ok,
                    lp_failed=stats.lp_failed + (mask & ~ok),
                    lp_offloaded=stats.lp_offloaded + offl,
                    lp_four_core=stats.lp_four_core + (ok & use4),
                    start_delay_sum=stats.start_delay_sum
                    + torch.where(ok, start - release, 0.0),
                    comm_busy=stats.comm_busy
                    + torch.where(offl, ttime, 0.0),
                    remainders_dropped=stats.remainders_dropped + nd,
                )
                frame_ok = frame_ok & (ok | (k >= n_lp))
                if capture:
                    lp_placed_d = lp_placed_d + _i32(ok)
            stats = stats._replace(
                frames_completed=stats.frames_completed
                + (has_frame & frame_ok)
            )
        if capture:
            pd_run.append(hp_ok)
            pd_fail.append(hp_fail)
            pd_preempt.append(preempt)
            pd_lp.append(lp_placed_d)
    new = (st, link_free, (rq_dl, rq_src, rq_ok),
           (vc_s, vc_end, vc_dl, vc_src, vc_ok), stats)
    if not capture:
        return new, None
    frame = _telemetry.capture_tick(
        st, link_free, rq_ok, stats0, stats, base, bws, p.nominal_bw_bps,
        torch.stack(pd_run, 1), torch.stack(pd_fail, 1),
        torch.stack(pd_preempt, 1), torch.stack(pd_lp, 1),
    )
    return new, frame


def _check_tick(carry) -> None:
    """The reference's per-tick invariants (``REPRO_SANITIZE=1``)."""
    st, link_free, _, (vc_s, vc_end, _, _, vc_ok), _ = carry
    _sanitize.check_windows(st.win_t1, st.win_t2, st.win_valid, "fleet tick")
    _sanitize.check(
        (~vc_ok | (vc_s <= vc_end)).all(),
        "victim cache corrupt (fleet tick): a live entry has start > end",
    )
    _sanitize.check(
        (link_free >= 0.0).all(),
        "negative link_free (fleet tick): {lf}", lf=lambda: link_free.min(),
    )


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equally nested carries."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    out = [_tree_map(fn, *xs) for xs in zip(*trees)]
    return type(t)(*out) if hasattr(t, "_fields") else tuple(out)


def fleet_run(fleet: FleetState, values, bw_scale, *, params: FleetParams):
    """Advance a whole fleet over ``values`` ([F, B, Dev] workload) in
    ``segment_frames``-tick segments; ``bw_scale`` is [F, B] (or
    broadcasts to it). Runs on the device of the fleet's tensors and
    returns ``(state, stats)`` — or ``(state, stats, telemetry_record)``
    when ``params.telemetry`` is on (``obs/telemetry.py``; state and stats
    are bit-identical either way). The input ``fleet`` is left untouched:
    the engine runs on a copy, which the CUDA kernel then updates in place.

    With ``params.mesh_shards >= 1`` the batch is split across
    ``fleet/mesh.py``'s devices: B is padded to a multiple of the shard
    count with no-op replicas (no frames, bandwidth scale 1, state tiled
    from existing rows), each shard advances on its own device, the
    shards taking turns tick by tick, and the outputs are gathered on the
    fleet's device with the padding trimmed; results are bit-identical
    to the unsharded engine. ``REPRO_SANITIZE=1`` checks each segment's
    input state and every tick's windows, victim cache and link
    (``analysis/sanitize.py``), raising ``SanitizeError`` on a trip; the
    results and launches are the same either way.

    The whole loop runs in ``maybe_torch_trace()``, and under an active
    ``obs/profile.py`` timer the loop is a tree of spans: each segment a
    ``fleet/segment``, in it each shard's tick a ``fleet/tick`` (traced
    ``(run, f)``, ``run`` fresh each call, on the shard's device), and in
    that the phases of ``_frame_step``. Under a device-timed timer each
    span is also timed on the device, and every ``fused_place`` launch
    adds its rows attempted and committed to the counter
    ``fleet/fused_place`` ([1 + Dev·(1 + MAX_LP), 2], one row an attempt
    slot, as ``_frame_step`` numbers them) inside the kernel: no launch of
    its own; every HP commit adds its rows committed and rows whose windows
    changed to row ``d`` of the counter ``fleet/hp_commit`` ([Dev, 2]), in
    the fan-out commit kernel the same way. Results are bit-identical with
    and without a timer.
    """
    p = params
    device = fleet.link_free.device
    B = fleet.sched.win_t1.shape[0]
    n_dev = p.n_devices
    R = p.requeue_slots
    values = torch.as_tensor(values).to(device, torch.int32)
    F = values.shape[0]
    if values.shape[1:] != (B, n_dev) or fleet.sched.win_t1.shape[1] != n_dev:
        raise ValueError(f"workload {tuple(values.shape)} does not match a "
                         f"fleet of B={B}, Dev={n_dev}")
    if tuple(fleet.rq_valid.shape) != (B, R):
        raise ValueError(
            f"fleet re-queue buffer {tuple(fleet.rq_valid.shape)} != (B={B}, "
            f"requeue_slots={R}); build the fleet with matching "
            f"requeue_slots")
    if p.telemetry_every < 1:
        raise ValueError("telemetry_every must be >= 1")
    bw_scale = torch.as_tensor(bw_scale).to(device, torch.float32)
    bw_scale = bw_scale.expand(F, B)
    S = F if p.segment_frames <= 0 else min(p.segment_frames, F)
    every = p.telemetry_every
    if p.telemetry and every > 1:
        # segments a multiple of the stride, as the reference's
        S = max(every, S - S % every)
    devices = ([device] if p.mesh_shards < 1
               else _mesh.fleet_devices(p.mesh_shards, device))
    n_shards = len(devices)
    state = (fleet.sched, fleet.link_free,
             (fleet.rq_deadline, fleet.rq_src, fleet.rq_valid),
             (fleet.vc_start, fleet.vc_end, fleet.vc_deadline, fleet.vc_src,
              fleet.vc_valid))
    if n_shards == 1:
        carries = [(*_tree_map(torch.clone, state),
                    init_stats(B, device=device))]
        work = [(values, bw_scale)]
    else:
        pad_b = _mesh.shard_pad(B, n_shards)
        if pad_b:
            # padded replicas release no frames (-1), so they advance as
            # no-ops; their state tiles existing rows (any valid state)
            values = torch.cat([values, torch.full(
                (F, pad_b, n_dev), -1, dtype=torch.int32, device=device)], 1)
            bw_scale = torch.cat([bw_scale, torch.ones(
                (F, pad_b), dtype=torch.float32, device=device)], 1)
        per = (B + pad_b) // n_shards
        carries, work = [], []
        for i, dev in enumerate(devices):
            rows = torch.arange(i * per, (i + 1) * per, device=device) % B
            carries.append((
                *_tree_map(lambda x: x.index_select(0, rows).to(dev), state),
                init_stats(per, device=dev)))
            cols = slice(i * per, (i + 1) * per)
            work.append((values[:, cols].to(dev), bw_scale[:, cols].to(dev)))
    sanitize = _sanitize.enabled()
    segments = []
    run_id = _profile.next_run_id()
    # each shard's device, and its attempt and HP commit counters, zeroed
    # before the loop (None without a device-timed timer)
    shard_devices = [carry[1].device for carry in carries]
    counts = [_profile.counter("fleet/fused_place",
                               (1 + n_dev * (1 + MAX_LP), 2), dev)
              for dev in shard_devices]
    hp_counts = [_profile.counter("fleet/hp_commit", (n_dev, 2), dev)
                 for dev in shard_devices]
    with _profile.maybe_torch_trace():
        for f0 in range(0, F, max(S, 1)):
            with _profile.span("fleet/segment", device=device):
                rows_kept = [[] for _ in carries]
                if sanitize:
                    for carry in carries:
                        _sanitize.check_sched_state(carry[0],
                                                    "fleet segment input")
                for f in range(f0, min(f0 + S, F)):
                    capture = p.telemetry and f % every == 0
                    for i, (v, bw) in enumerate(work):
                        with _profile.span("fleet/tick", trace=(run_id, f),
                                           device=shard_devices[i]):
                            carries[i], frame = _frame_step(
                                carries[i], f, v[f], bw[f], p, capture,
                                counts[i], hp_counts[i])
                        if sanitize:
                            _check_tick(carries[i])
                        if capture:
                            rows_kept[i].append(frame)
                if p.telemetry:
                    # the segment's rows stay on the device until the end
                    segments.append([_telemetry.stack_frames(r)
                                     for r in rows_kept])
    if n_shards == 1:
        carry = carries[0]
    else:
        carry = _tree_map(
            lambda *xs: torch.cat([x.to(device) for x in xs])[:B], *carries)
    sched, link_free, rq, vc, stats = carry
    out = FleetState(
        sched=SchedState(*sched), link_free=link_free,
        now=torch.full((B,), F * FRAME_PERIOD, dtype=torch.float32,
                       device=device),
        rq_deadline=rq[0], rq_src=rq[1], rq_valid=rq[2],
        vc_start=vc[0], vc_end=vc[1], vc_deadline=vc[2], vc_src=vc[3],
        vc_valid=vc[4],
    )
    if not p.telemetry:
        return out, stats
    host = [
        _telemetry.TelemetryFrame(*(
            np.concatenate(xs, axis=1) for xs in zip(*(
                _telemetry.frame_to_numpy(fr) for fr in shard_frames))))
        for shard_frames in segments
    ]
    record = _telemetry.assemble(
        host, n_frames=F, every=every, nominal_bw_bps=p.nominal_bw_bps,
        n_replicas=B,
    )
    return out, stats, record
