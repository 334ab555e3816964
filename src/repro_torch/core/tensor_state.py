"""The paper's §IV data structures as tensors: the state the batched fleet
engine carries, and the commit and compaction steps it applies to it.

Counterpart of ``repro/core/jax_state.py``: the fleet's commit and
compaction, and the single-controller placements ``hp_place`` and
``lp_place``. The Python structures in ``windows.py`` / ``netlink.py``
remain the reference; ``export_state`` converts a live RASScheduler.

State layout (one NamedTuple of tensors):

    win_t1, win_t2      f32[DEV, CFG, T, W]   availability windows
    win_valid           bool[DEV, CFG, T, W]
    min_dur             f32[CFG]              per-config minimum duration
    link_t1, link_t2    f32[B]                discretised link buckets
    link_cap, link_used i32[B]

Every function here is exact f32 compare / min / max / select / add, so it
reproduces the JAX package bit for bit on the same inputs, provided sums
run in the same order: the track overlap ``ol`` is summed lane 0 to lane
W-1 in sequence (``_seq_sum``), as XLA reduces it on the host. A different
order can flip a near-tie in the track ranking and trim another track.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.analysis import sanitize as _sanitize
from repro_torch.core.tasks import ALL_CONFIGS, DEVICE_CORES

BIG = 1e30


class SchedState(NamedTuple):
    win_t1: torch.Tensor     # [DEV, CFG, T, W]
    win_t2: torch.Tensor
    win_valid: torch.Tensor
    min_dur: torch.Tensor    # [CFG]
    link_t1: torch.Tensor    # [B]
    link_t2: torch.Tensor
    link_cap: torch.Tensor
    link_used: torch.Tensor


CFG_INDEX = {c.name: i for i, c in enumerate(ALL_CONFIGS)}


def export_state(sched, max_windows: int = 16, *, device=None) -> SchedState:
    """Snapshot a live RASScheduler into tensor form on ``device``
    (``None`` -> CUDA, see ``_device.resolve_device``)."""
    device = resolve_device(device)
    n_dev = sched.n_devices
    n_cfg = len(ALL_CONFIGS)
    max_tracks = max(
        sched.devices[0].lists[c.name].track_count for c in ALL_CONFIGS
    )
    t1 = np.full((n_dev, n_cfg, max_tracks, max_windows), BIG, np.float32)
    t2 = np.full_like(t1, BIG)
    valid = np.zeros(t1.shape, bool)
    for d, dev in enumerate(sched.devices):
        for ci, cfg in enumerate(ALL_CONFIGS):
            al = dev.lists[cfg.name]
            for ti, track in enumerate(al.tracks):
                for wi, w in enumerate(track[:max_windows]):
                    t1[d, ci, ti, wi] = w.t1
                    t2[d, ci, ti, wi] = min(w.t2, BIG)
                    valid[d, ci, ti, wi] = True
    link = sched.link

    def tensor(x, dtype):
        return torch.tensor(x, dtype=dtype, device=device)

    return SchedState(
        win_t1=torch.from_numpy(t1).to(device),
        win_t2=torch.from_numpy(t2).to(device),
        win_valid=torch.from_numpy(valid).to(device),
        min_dur=tensor([c.padded_time for c in ALL_CONFIGS], torch.float32),
        link_t1=tensor([b.t1 for b in link.buckets], torch.float32),
        link_t2=tensor([b.t2 for b in link.buckets], torch.float32),
        link_cap=tensor([b.capacity for b in link.buckets], torch.int32),
        link_used=tensor([len(b.items) for b in link.buckets], torch.int32),
    )


# ---------------------------------------------------------------------------
# config geometry (static tables used by the fan-out commit)
# ---------------------------------------------------------------------------

#: cores per track of each config list == the config's own core count.
CFG_CORES = np.array([c.cores for c in ALL_CONFIGS], np.int32)

#: tracks per config list.
CFG_TRACKS = (DEVICE_CORES // CFG_CORES).astype(np.int32)

#: OCC_TABLE[task_cfg, list_cfg] — how many tracks of ``list_cfg`` a
#: committed ``task_cfg`` task occupies: ceil(task_cores / track_cores),
#: capped at the list's track count (the §IV.A.1 fan-out width; matches
#: AvailabilityList.subtract's ``occupy_tracks``).
OCC_TABLE = np.minimum(
    -(-CFG_CORES[:, None] // CFG_CORES[None, :]), CFG_TRACKS[None, :]
).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _occ_table(device: torch.device) -> torch.Tensor:
    """``OCC_TABLE`` on ``device``, copied there once (a copy from host
    memory waits for the device)."""
    return torch.as_tensor(OCC_TABLE, device=device)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis from lane 0 upward, one add at a time — the
    order XLA uses on the host. ``torch.sum`` (and ``cumsum`` on the card)
    associate differently and can differ in the last bit."""
    acc = torch.zeros_like(x[..., 0])
    for w in range(x.shape[-1]):
        acc = acc + x[..., w]
    return acc


def _csum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive integer cumsum over the last axis (exact in any order)."""
    return torch.cumsum(x, dim=-1)


def _trim_tracks(t1, t2, valid, s, e, md, active):
    """Multi-remainder trim of ``[s, e)`` from every window of the active
    tracks (``[..., W]`` tensors; ``s``/``e``/``md``/``active`` broadcast).

    Every overlapping window keeps its left piece ``[t1, s)`` and right
    piece ``[e, t2)`` when they satisfy the minimum duration — the exact
    semantics of ``AvailabilityList.subtract``. Pieces stay in place: a
    window keeps its slot for its surviving piece (left preferred), so only
    the straddle window — one whose left AND right pieces both survive —
    needs a second slot; its right piece spills into the first free slot.
    Every slot left invalid is reset to ``BIG``.

    Pieces that satisfy the minimum duration but find no free slot are
    counted, never silently lost: returns ``(t1', t2', valid', n_dropped,
    time_dropped)`` with the drop tallies reduced over the window axis.
    """
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
    # one-hot sums: a single non-zero term, exact in any order
    sp_t1 = torch.where(oh_b, right_t1, 0.0).sum(-1, keepdim=True)
    sp_t2 = torch.where(oh_b, t2, 0.0).sum(-1, keepdim=True)
    place = placed & (lanes == first_free)
    new_t1 = torch.where(place, sp_t1, new_t1)
    new_t2 = torch.where(place, sp_t2, new_t2)
    new_valid = new_valid | place
    # every straddle right piece except a successfully placed first one
    # is dropped (counted, not lost)
    dropped = both & ~(placed & (lanes == first_both))
    n_drop = dropped.sum(-1, dtype=torch.int32)
    t_drop = _seq_sum(torch.where(dropped, t2 - right_t1, 0.0))
    return new_t1, new_t2, new_valid, n_drop, t_drop


def fanout_commit(t1, t2, valid, min_dur, dev, cfg, s, e, do, *,
                  sanitize: bool = False):
    """Batched §IV.A.1 fan-out commit: consume ``[s, e)`` on device ``dev``
    across every config list, trimming the ``OCC_TABLE[cfg, ci]``
    most-overlapping tracks of each list ``ci`` (multi-remainder).

    Shapes: windows ``[N, Dev, CFG, T, W]``; ``min_dur [N, CFG]``;
    ``dev``/``cfg`` int ``[N]``; ``s``/``e`` f32 ``[N]``; ``do`` bool
    ``[N]`` masks the commit per row. Returns new tensors
    ``(t1', t2', valid', n_dropped [N], time_dropped [N])``; the inputs are
    not modified, and rows with ``do=False`` are copied bit for bit.
    ``sanitize=True`` checks window order and that no row's availability
    grew (``analysis/sanitize.py``); it changes no result.
    """
    N, n_dev, n_cfg, T, W = t1.shape
    rows = torch.arange(N, device=t1.device)
    dev = dev.long()
    t1d = t1[rows, dev]                                        # [N, CFG, T, W]
    t2d = t2[rows, dev]
    vd = valid[rows, dev]
    sb = s[:, None, None, None]
    eb = e[:, None, None, None]
    ov = vd & (t1d < eb) & (sb < t2d)
    ol = _seq_sum(torch.where(
        ov, torch.minimum(t2d, eb) - torch.maximum(t1d, sb), 0.0
    ))                                                         # [N, CFG, T]
    # stable descending rank of tracks by overlap (first index wins ties)
    track_ids = torch.arange(T, device=t1.device)
    beats = (ol[..., None, :] > ol[..., :, None]) | (
        (ol[..., None, :] == ol[..., :, None])
        & (track_ids[None, :] < track_ids[:, None])
    )
    rank = beats.sum(-1)                                       # [N, CFG, T]
    occ = _occ_table(t1.device)[cfg.long()]                   # [N, CFG]
    active = do[:, None, None] & (rank < occ[:, :, None]) & (ol > 0.0)
    md = min_dur[:, :, None, None]
    nt1, nt2, nv, n_drop, t_drop = _trim_tracks(
        t1d, t2d, vd, sb, eb, md, active[..., None]
    )
    # write back only committed rows (do=False rows stay bit-identical)
    dom = do[:, None, None, None]
    out_t1 = t1.clone()
    out_t2 = t2.clone()
    out_valid = valid.clone()
    out_t1[rows, dev] = torch.where(dom, nt1, t1d)
    out_t2[rows, dev] = torch.where(dom, nt2, t2d)
    out_valid[rows, dev] = torch.where(dom, nv, vd)
    n_drop = torch.where(do, n_drop.sum((1, 2), dtype=torch.int32), 0)
    t_drop = torch.where(do, _seq_sum(t_drop.reshape(N, -1)), 0.0)
    if sanitize:
        _sanitize.check_windows(out_t1, out_t2, out_valid, "fanout_commit")
        _sanitize.check_no_avail_increase(
            _sanitize.total_availability(t1, t2, valid, batch_axes=1),
            _sanitize.total_availability(
                out_t1, out_t2, out_valid, batch_axes=1
            ),
            "fanout_commit",
        )
    return out_t1, out_t2, out_valid, n_drop, t_drop


def compact_tracks(t1, t2, valid, *, eps: float = 1e-6):
    """Per-track window compaction: sort windows by start and merge
    adjacent/abutting ones (``next.t1 <= prev.t2 + eps``) so remainders
    produced by repeated bisects cannot clog the fixed-W slots. ``[..., W]``
    tensors -> ``(t1', t2', valid')``.

    The sort is stable, like ``jnp.argsort``: every invalid window sorts on
    the same ``BIG`` key, and their order decides which slots come back.
    """
    W = t1.shape[-1]
    order = torch.argsort(torch.where(valid, t1, BIG), dim=-1, stable=True)
    t1s = torch.take_along_dim(t1, order, dim=-1)
    t2s = torch.take_along_dim(t2, order, dim=-1)
    vs = torch.take_along_dim(valid, order, dim=-1)
    cmax = torch.cummax(torch.where(vs, t2s, -BIG), dim=-1).values
    prev_end = torch.cat(
        [torch.full_like(cmax[..., :1], -BIG), cmax[..., :-1]], dim=-1
    )
    starts_seg = vs & (t1s > prev_end + eps)
    seg = _csum(starts_seg.to(torch.int32)) - 1
    lanes = torch.arange(W, device=t1.device)
    member = vs[..., None] & (seg[..., None] == lanes)         # [..., W, W]
    head = starts_seg[..., None] & (seg[..., None] == lanes)
    new_valid = member.any(-2)
    new_t1 = torch.where(
        new_valid, torch.where(head, t1s[..., None], 0.0).sum(-2), BIG
    )
    new_t2 = torch.where(
        new_valid, torch.where(member, t2s[..., None], -BIG).amax(-2), BIG
    )
    return new_t1, new_t2, new_valid


def compact_state(state: SchedState) -> SchedState:
    """Apply window compaction to every (device, config, track) of a
    (possibly batched) SchedState."""
    t1, t2, valid = compact_tracks(
        state.win_t1, state.win_t2, state.win_valid
    )
    return state._replace(win_t1=t1, win_t2=t2, win_valid=valid)


# ---------------------------------------------------------------------------
# single-controller placement (pure functions of SchedState)
# ---------------------------------------------------------------------------

def _total(state: SchedState):
    return _sanitize.total_availability(
        state.win_t1, state.win_t2, state.win_valid)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _device_slot(state: SchedState, dev, cfg_idx: int, q1, deadline, dur):
    """Earliest feasible ``(found, start)`` on device ``dev`` and config
    ``cfg_idx``. ``dev`` is an int or an index tensor; a tensor of devices
    gives one answer each (the JAX package ``vmap``s this over devices).
    The JAX package also returns the window's track and slot, which its
    callers ignore."""
    t1 = state.win_t1[dev, cfg_idx]          # [..., T, W]
    t2 = state.win_t2[dev, cfg_idx]
    valid = state.win_valid[dev, cfg_idx]
    start = torch.maximum(t1, q1)
    feasible = valid & (start + dur <= torch.minimum(t2, deadline))
    best = torch.where(feasible, start, BIG).flatten(-2).amin(-1)
    return best < BIG, best


def _bisect(state: SchedState, dev, cfg_idx: int, s, e, do=True,
            sanitize: bool = False):
    """Consume ``[s, e)`` from device ``dev`` across every config list (the
    §IV.A.1 fan-out write) for a committed task of config ``cfg_idx``,
    keeping every min-duration remainder; ``do`` masks the commit;
    ``sanitize`` checks the commit (``fanout_commit``). Returns
    ``(new_state, n_dropped)``. (The JAX package's ``track`` and ``slot``
    arguments, which it ignores, are left out.)"""
    device = state.win_t1.device
    one = lambda x, dtype: torch.as_tensor(
        x, dtype=dtype, device=device).reshape(1)
    t1, t2, valid, n_drop, _ = fanout_commit(
        state.win_t1[None], state.win_t2[None], state.win_valid[None],
        state.min_dur[None], one(dev, torch.int32),
        one(cfg_idx, torch.int32), one(s, torch.float32),
        one(e, torch.float32), one(do, torch.bool), sanitize=sanitize,
    )
    return state._replace(
        win_t1=t1[0], win_t2=t2[0], win_valid=valid[0]), n_drop[0]


def hp_place(state: SchedState, dev, now, *, cfg_idx: int = 0):
    """High-priority placement (§IV.B.1): strict containment of
    ``[now, now + dur)`` on the source device ``dev``, committed.
    Returns ``(found, start, new_state)``; ``state`` is left as it was.
    Under ``REPRO_SANITIZE=1`` the input, the commit and the output are
    checked (``analysis/sanitize.py``), raising ``SanitizeError`` on a trip;
    the results are the same either way."""
    sanitize = _sanitize.enabled()
    if sanitize:
        _sanitize.check_sched_state(state, "hp_place input")
        before = _total(state)
    device = state.win_t1.device
    now = _f32(now, device)
    dur = state.min_dur[cfg_idx]
    found, start = _device_slot(
        state, dev, cfg_idx, now, now + dur + _f32(1e-6, device), dur)
    new_state, _ = _bisect(state, dev, cfg_idx, start, start + dur,
                           do=found, sanitize=sanitize)
    if sanitize:
        _sanitize.check_sched_state(new_state, "hp_place output")
        _sanitize.check_no_avail_increase(before, _total(new_state),
                                          "hp_place")
    return found, start, new_state


def lp_place(state: SchedState, src_dev, now, deadline, *,
             cfg_idx: int = 1, n_tasks: int = 1):
    """Low-priority request (§IV.B.2) of ``n_tasks`` tasks: for each in
    turn, reserve a link slot, run the multi-containment query across all
    devices, prefer the source device, commit the placement. Returns
    ``(all_ok, oks, devs, starts, new_state)`` with ``oks``, ``devs``
    (int32) and ``starts`` of length ``n_tasks``; ``state`` is left as it
    was. The JAX package's ``lax.scan`` over the tasks is a loop here.
    ``REPRO_SANITIZE=1`` checks as ``hp_place`` does."""
    sanitize = _sanitize.enabled()
    if sanitize:
        _sanitize.check_sched_state(state, "lp_place input")
        before = _total(state)
    device = state.win_t1.device
    now, deadline = _f32(now, device), _f32(deadline, device)
    dur = state.min_dur[cfg_idx]
    devs_all = torch.arange(state.win_t1.shape[0], dtype=torch.int32,
                            device=device)
    is_src = devs_all == torch.as_tensor(src_dev, device=device)
    src_pref = torch.where(is_src, _f32(1e-3, device), _f32(0.0, device))
    st = state
    oks, devs, starts = [], [], []
    for _ in range(n_tasks):
        # link reservation: the first non-full bucket ending after now
        ok_link = (st.link_used < st.link_cap) & (st.link_t2 > now)
        idx = ok_link.to(torch.int8).argmax()
        comm_ok = ok_link.any()
        link_used = st.link_used.clone()
        link_used[idx] += comm_ok.to(torch.int32)
        comm_end = st.link_t2[idx]
        st = st._replace(link_used=link_used)
        # multi-containment across every device
        founds, found_starts = _device_slot(
            st, devs_all, cfg_idx, now, deadline, dur)
        # remote devices cannot start before their transfer lands
        starts_adj = torch.where(is_src, found_starts,
                                 torch.maximum(found_starts, comm_end))
        feasible = founds & (starts_adj + dur <= deadline)
        feasible = feasible & (is_src | comm_ok)
        # prefer the source device, then the earliest start
        key = torch.where(feasible, starts_adj, BIG) - src_pref
        d = key.argmin()
        ok = feasible[d]
        start = starts_adj[d]
        st, _ = _bisect(st, d, cfg_idx, start, start + dur, do=ok,
                        sanitize=sanitize)
        oks.append(ok)
        devs.append(d.to(torch.int32))
        starts.append(start)
    oks, devs, starts = torch.stack(oks), torch.stack(devs), torch.stack(starts)
    if sanitize:
        _sanitize.check_sched_state(st, "lp_place output")
        _sanitize.check_no_avail_increase(before, _total(st), "lp_place")
    return oks.all(), oks, devs, starts, st
