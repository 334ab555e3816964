"""Fleet statistics: per-replica counters and their host-side reduction.

`FleetStats` is a NamedTuple of `[B]` tensors carried through the engine;
`summarize` reduces a (sub-)batch to Fig.-4-style rates with 95%
confidence intervals over replicas, on the host in numpy.

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

from typing import NamedTuple

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
    here). ``s`` maps counter names to float arrays of the namespace."""
    frames = xp.maximum(s["frames"], 1)
    lp = xp.maximum(s["lp_spawned"], 1)
    # placements ever committed = net completions + revoked victim credits
    # (offload/4-core counters accrue at placement time and are not
    # unwound by preemption, so they normalise by this total)
    placed = xp.maximum(s["lp_completed"] + s["hp_preempted"], 1)
    victims = xp.maximum(s["hp_preempted"], 1)
    # only *initial* placements carry a start-delay sample (the requeue
    # paths measure nothing), so the mean excludes realloc placements
    initial = xp.maximum(
        s["lp_completed"] + s["hp_preempted"] - s["lp_requeued"], 1
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
