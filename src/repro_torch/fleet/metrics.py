"""Fleet statistics: per-replica counters and their reduction.

`FleetStats` is a NamedTuple of `[B]` tensors carried through the engine;
`summarize` reduces a (sub-)batch to Fig.-4-style rates with 95%
confidence intervals over replicas, on the host in numpy, and
`cell_moments` reduces a batch to per-cell rate moments on its device
(the sharded sweep's O(cells × metrics) host transfer).

Preemption counters follow the serial engine's accounting:

- ``hp_preempted`` counts **committed** preemptions only — an HP
  containment miss that found no evictable LP victim is an admission
  failure (``hp_failed``), not a preemption.
- ``lp_requeued`` counts victims successfully re-placed by the per-tick
  reallocation pass.
- ``missed_by_preemption`` counts victims dropped because their deadline
  expired before re-placement or the bounded re-queue buffer was full.

Conservation: every spawned LP task ends in exactly one of completed /
failed / missed_by_preemption / still-pending-in-buffer, i.e.

    lp_spawned == lp_completed + lp_failed + missed_by_preemption
                  + rq_valid.sum(axis=1)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.tasks import FRAME_PERIOD


class FleetStats(NamedTuple):
    frames: torch.Tensor             # i32[B] frames released
    frames_completed: torch.Tensor   # i32[B] HP + every LP task in time
    hp_completed: torch.Tensor       # i32[B]
    hp_preempted: torch.Tensor       # i32[B] committed preemptions (= victims)
    hp_failed: torch.Tensor          # i32[B] admission failed: nothing to evict
    lp_spawned: torch.Tensor         # i32[B]
    lp_completed: torch.Tensor       # i32[B] placed with end <= deadline,
    #                                         net of revoked victim credit
    lp_failed: torch.Tensor          # i32[B] deadline-infeasible everywhere
    lp_requeued: torch.Tensor        # i32[B] victims re-placed after eviction
    missed_by_preemption: torch.Tensor  # i32[B] victims expired / buffer-full
    lp_offloaded: torch.Tensor       # i32[B]
    lp_four_core: torch.Tensor       # i32[B] widened to the 4-core config
    start_delay_sum: torch.Tensor    # f32[B] Σ (start - release) of placed LP
    comm_busy: torch.Tensor          # f32[B] link seconds spent transferring
    remainders_dropped: torch.Tensor  # i32[B] min-duration remainders lost
    #                                   to full window arrays


def init_stats(batch: int, *, device=None) -> FleetStats:
    device = resolve_device(device)
    return FleetStats(*(
        torch.zeros((batch,), dtype=torch.float32 if f in (
            "start_delay_sum", "comm_busy") else torch.int32, device=device)
        for f in FleetStats._fields
    ))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def stats_to_numpy(stats: FleetStats) -> FleetStats:
    """The same counters, as numpy arrays on the host."""
    return FleetStats(*map(_host, stats))


def _mean_ci(x: np.ndarray) -> dict:
    x = np.asarray(x, np.float64)
    n = x.size
    mean = float(x.mean()) if n else 0.0
    ci = float(1.96 * x.std(ddof=1) / np.sqrt(n)) if n > 1 else 0.0
    return {"mean": round(mean, 4), "ci95": round(ci, 4)}


def conservation_residual(stats: FleetStats, rq_pending) -> np.ndarray:
    """Per-replica residual of the LP-task conservation identity above:
    ``lp_spawned - (lp_completed + lp_failed + missed_by_preemption +
    rq_pending)``. Exactly zero unless the engine has lost or
    double-counted a task; ``rq_pending`` is the end-of-run re-queue
    occupancy ``FleetState.rq_valid.sum(axis=1)``."""
    s = {k: _host(v).astype(np.int64) for k, v in stats._asdict().items()
         if k in ("lp_spawned", "lp_completed", "lp_failed",
                  "missed_by_preemption")}
    pending = _host(rq_pending).astype(np.int64)
    return s["lp_spawned"] - (s["lp_completed"] + s["lp_failed"]
                              + s["missed_by_preemption"] + pending)


def _rates_impl(s: dict, rq_pending, xp) -> dict:
    """The counter→rate algebra over an array namespace (``xp`` is numpy
    for the host path, torch inside the on-device cell reduction — one
    body, so the two can never drift apart). ``s`` maps counter names to
    float arrays of the namespace. ``clip`` stands for the reference's
    ``maximum(x, 1)``: torch's ``maximum`` takes no Python scalar."""
    frames = xp.clip(s["frames"], 1, None)
    lp = xp.clip(s["lp_spawned"], 1, None)
    # placements ever committed = net completions + revoked victim credits
    # (offload/4-core counters accrue at placement time and are not
    # unwound by preemption, so they normalise by this total)
    placed = xp.clip(s["lp_completed"] + s["hp_preempted"], 1, None)
    victims = xp.clip(s["hp_preempted"], 1, None)
    # only *initial* placements carry a start-delay sample (the requeue
    # paths measure nothing), so the mean excludes realloc placements
    initial = xp.clip(
        s["lp_completed"] + s["hp_preempted"] - s["lp_requeued"], 1, None
    )
    out = {
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
    }
    if rq_pending is not None:
        # end-of-run re-queue buffer depth: the only term of the
        # conservation identity the counters alone do not report
        out["rq_pending_depth"] = rq_pending
    return out


def per_replica_rates(stats: FleetStats, rq_pending=None) -> dict:
    """Per-replica `[B]` rate arrays (numpy). Pass the end-of-run re-queue
    occupancy as ``rq_pending`` to also report the one conservation term
    the counters alone cannot see."""
    s = {k: _host(v).astype(np.float64) for k, v in stats._asdict().items()}
    pending = (None if rq_pending is None
               else _host(rq_pending).astype(np.float64))
    return _rates_impl(s, pending, np)


# ---------------------------------------------------------------------------
# on-device cell reduction (sharded sweeps)
# ---------------------------------------------------------------------------
#
# A sharded sweep never pulls per-replica arrays to the host: the rates
# above are evaluated on the batch's device (same `_rates_impl` body, torch
# namespace), grouped by an `owner` cell id per replica, and reduced to
# per-cell first/second moments, summed over the shards where the
# reference uses `lax.psum` (a max where it uses `lax.pmax`). The host
# receives `[C, K]` moment arrays — O(cells × metrics), independent of B
# and of the O(B·Dev·CFG·T·W) window state.

class CellMoments(NamedTuple):
    """Per-cell sufficient statistics of the per-replica rate vectors.

    ``count[C]`` replicas per cell, ``mean[C, K]``/``m2[C, K]`` the mean
    and centred second moment of each rate (K = ``len(cell_rate_keys())``,
    last column is the conservation residual), ``resid_max_abs[C]`` the
    per-cell worst |residual|.  Padding replicas carry ``owner == -1``
    and contribute to nothing.
    """

    count: np.ndarray          # f32[C]
    mean: np.ndarray           # f32[C, K]
    m2: np.ndarray             # f32[C, K]
    resid_max_abs: np.ndarray  # i32[C]


def _device_rates(stats: FleetStats, rq_pending, n_frames: int) -> dict:
    """`_rates_impl` under torch, plus the two absolute-time rates that
    `summarize` derives outside the algebra — the on-device reduction
    must cover everything the host summary reports."""
    s = {k: v.to(torch.float32) for k, v in stats._asdict().items()}
    rates = _rates_impl(s, rq_pending.to(torch.float32), torch)
    sim_time = n_frames * FRAME_PERIOD
    # a tensor over a Python float is a product with its reciprocal on
    # CUDA, which can differ from the quotient in the last bit: far inside
    # the sweep's 1e-5 agreement with the reference
    rates["link_utilisation"] = s["comm_busy"] / sim_time
    rates["lp_throughput_per_s"] = s["lp_completed"] / sim_time
    return rates


def cell_rate_keys() -> tuple[str, ...]:
    """Ordered rate names of the ``mean``/``m2`` columns (the residual
    column is appended by ``cell_moments``)."""
    dummy = FleetStats(*(np.zeros((1,), np.int32) for _ in
                         FleetStats._fields))
    keys = list(per_replica_rates(dummy, rq_pending=np.zeros((1,))))
    keys += ["link_utilisation", "lp_throughput_per_s",
             "conservation_residual"]
    return tuple(keys)


def _cell_sum(oh: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """``oh.T @ mat`` for a 0/1 ``oh`` [B, C] and ``mat`` [B, K], as a
    masked sum: a matrix product could run in TF32 where the process
    allows it, which rounds ``mat`` to 10 mantissa bits."""
    return (oh.T[:, :, None] * mat[None]).sum(1)


def cell_moments(stats: FleetStats, rq_valid, owner, *, n_cells: int,
                 n_frames: int, shards: int = 1) -> CellMoments:
    """Reduce a batch to per-cell rate moments on its device.

    ``owner`` is ``i32[B]`` mapping each replica to its grid cell (``-1``
    = padding, excluded from every reduction). The batch is ``shards``
    equal row blocks (the sharded engine's); each block reduces alone and
    the blocks' counts and sums are summed before the mean, their centred
    second moments after it, and their residual maxima maxed — the
    reference's `psum`/`pmax` over the mesh. The two-pass centred second
    moment (mean first, then Σ(x−mean)²) keeps f32 variance stable at
    10⁶ replicas. Returns tensors on the batch's device.
    """
    pending = rq_valid.sum(1, dtype=torch.int32)
    rates = _device_rates(stats, pending, n_frames)
    resid = (stats.lp_spawned - stats.lp_completed - stats.lp_failed
             - stats.missed_by_preemption - pending).to(torch.int32)
    rates["conservation_residual"] = resid.to(torch.float32)
    mat = torch.stack(list(rates.values()), 1)               # [B, K]
    # owner == -1 matches no cell column, so padding drops out of every
    # count/sum/max below without an explicit mask
    cells = torch.arange(n_cells, dtype=owner.dtype, device=owner.device)
    oh = (owner[:, None] == cells[None, :]).to(torch.float32)  # [B, C]
    blocks = list(zip(oh.chunk(shards), mat.chunk(shards)))
    count = sum(o.sum(0) for o, _ in blocks)
    sums = sum(_cell_sum(o, m) for o, m in blocks)            # [C, K]
    mean = sums / torch.clamp(count, min=1.0)[:, None]
    centred = mat - mean[torch.clamp(owner, min=0).long()]
    m2 = sum(_cell_sum(o, c * c)
             for o, c in zip(oh.chunk(shards), centred.chunk(shards)))
    resid_max = torch.where(oh > 0, resid.abs()[:, None], 0).amax(0)
    return CellMoments(count, mean, m2, resid_max.to(torch.int32))


def merge_cell_moments(a: Optional[CellMoments],
                       b: CellMoments) -> CellMoments:
    """Combine per-cell moments of two disjoint replica populations
    (Chan et al. parallel-variance merge, float64 host-side) — the sweep
    folds one batch at a time into a running total."""
    b = CellMoments(*(_host(x).astype(np.float64) for x in b[:3]),
                    _host(b.resid_max_abs).astype(np.int64))
    if a is None:
        return b
    n = a.count + b.count
    safe = np.maximum(n, 1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.count / safe)[:, None]
    m2 = a.m2 + b.m2 + (delta * delta) * (
        a.count * b.count / safe
    )[:, None]
    return CellMoments(
        n, mean, m2, np.maximum(a.resid_max_abs, b.resid_max_abs)
    )


def summarize_cells(m: CellMoments, keys: tuple[str, ...] | None = None
                    ) -> list[dict]:
    """Per-cell summaries (same shape as ``summarize``'s dict) from
    reduced moments — the O(metrics) twin of the per-replica path."""
    keys = keys or cell_rate_keys()
    out = []
    for c in range(m.count.shape[0]):
        n = float(m.count[c])
        cell: dict = {"replicas": int(n)}
        for k, ki in zip(keys, range(len(keys))):
            mean = float(m.mean[c, ki])
            var = float(m.m2[c, ki]) / (n - 1.0) if n > 1 else 0.0
            ci = 1.96 * np.sqrt(max(var, 0.0) / n) if n > 1 else 0.0
            entry = {"mean": round(mean, 4), "ci95": round(float(ci), 4)}
            if k == "conservation_residual":
                entry["max_abs"] = int(m.resid_max_abs[c])
            cell[k] = entry
        out.append(cell)
    return out


def summarize(stats: FleetStats, n_frames: int, *, rq_pending=None) -> dict:
    """Reduce per-replica counters to mean ± 95% CI across the batch.

    With ``rq_pending`` (end-of-run ``FleetState.rq_valid.sum(axis=1)``)
    the summary additionally reports ``rq_pending_depth`` and the checked
    ``conservation_residual`` of the LP-task identity — any non-zero
    ``max_abs`` means the engine lost or double-counted a task."""
    s = {k: _host(v) for k, v in stats._asdict().items()}
    sim_time = n_frames * FRAME_PERIOD
    out = {"replicas": int(s["frames"].size)}
    out.update(
        (k, _mean_ci(v))
        for k, v in per_replica_rates(stats, rq_pending=rq_pending).items()
    )
    out["link_utilisation"] = _mean_ci(s["comm_busy"] / sim_time)
    out["lp_throughput_per_s"] = _mean_ci(s["lp_completed"] / sim_time)
    if rq_pending is not None:
        residual = conservation_residual(stats, rq_pending)
        out["conservation_residual"] = {
            **_mean_ci(residual),
            "max_abs": int(np.abs(residual).max()) if residual.size else 0,
        }
    return out
