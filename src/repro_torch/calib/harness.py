"""Matched-point comparison of the serial DES and the batched fleet engine.

Counterpart of ``repro/calib/harness.py``, with the port's fleet as the
fleet leg. For every (scenario, congestion) cell, ``n_seeds`` matched
points are run:

- **serial** — ``sim.engine.run_experiment`` (the copied DES, host
  Python) replays the exact §V trace ``generate_trace(scenario, n_frames,
  seed=s)`` under the event-driven model (controller serialisation,
  jitter, probe dynamics, §VI.C congestion bursts at the given duty
  cycle).
- **fleet** — the *same trace entries* are stacked along the batch axis
  (one replica column per seed) and advanced together by ``fleet_run`` on
  ``device``, with the fleet's §VI.C burst generator at the same duty
  cycle. On a CUDA device every tick launches the placement kernel 21
  times and the window-query kernel 4 times; ``FleetParams(
  placement_backend="ref")`` runs the plain path, which launches neither.

Both sides reduce to one shared rate vocabulary (``Metrics.calib_view`` /
``fleet_view``); the per-cell delta is ``fleet − serial`` of the
seed-averaged rates. The scenarios are restricted to the paper's trace
families because those are the only ones the serial engine replays.

What a delta means: the fleet engine is an *abstraction* of the DES (no
controller latency, no jitter, tick-granular victim reallocation), so
deltas are expected to be small but non-zero. The committed tolerance
bands in results/calib/baseline.json pin how far the abstraction may
drift (gate.py). The fleet is bit-identical to the JAX package's and the
serial leg is a copy of its DES, so a report equals the JAX package's.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Sequence

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.fleet.engine import FleetParams, fleet_run
from repro_torch.fleet.metrics import (
    FleetStats, per_replica_rates, stats_to_numpy,
)
from repro_torch.fleet.scenarios import _congestion_bursts
from repro_torch.fleet.state import make_fleet
from repro_torch.sim.engine import ExperimentConfig, run_experiment
from repro_torch.sim.traces import generate_trace

#: Trace families both engines can replay (§V).
PAPER_TRACES = ("uniform", "weighted1", "weighted2", "weighted3", "weighted4")

#: Rates compared between the two engines (present in both views).
#: ``lp_placed_rate`` is the matched comparison (the fleet has no run-time
#: jitter, so its completions correspond to serial placements-in-time);
#: ``lp_completion_rate`` additionally carries the serial jitter bias.
DELTA_KEYS = (
    "frame_completion_rate",
    "hp_completion_rate",
    "hp_failure_rate",
    "preemption_rate",
    "lp_completion_rate",
    "lp_placed_rate",
)


@dataclasses.dataclass(frozen=True)
class CalibConfig:
    scenarios: Sequence[str] = PAPER_TRACES
    congestion_levels: Sequence[float] = (0.0,)
    n_seeds: int = 3                  # matched points per cell
    n_frames: int = 95
    n_devices: int = 4
    base_seed: int = 0
    params: Optional[FleetParams] = None

    def fleet_params(self) -> FleetParams:
        if self.params is not None:
            return self.params
        return FleetParams(n_devices=self.n_devices)


def fleet_view(stats: FleetStats, reduce: bool = True) -> dict:
    """Per-replica fleet counters reduced to the calib rate vocabulary
    (the fleet analog of ``sim.metrics.Metrics.calib_view``).

    The counters are moved to the host first, on whatever device they
    lie. The rate algebra lives in ``fleet.metrics.per_replica_rates`` —
    this only renames to the shared vocabulary and adds raw counts. The
    fleet abstraction has no run-time jitter, so a placement in time IS a
    completion: ``lp_placed_rate == lp_completion_rate``.
    ``preemption_rate`` counts committed preemptions (= evicted victims),
    matching the serial engine's ``lp_preempted``.
    """
    stats = stats_to_numpy(stats)
    s = {k: np.asarray(v, np.float64) for k, v in stats._asdict().items()}
    r = per_replica_rates(stats)
    view = {
        "frames": s["frames"],
        "frame_completion_rate": r["frame_completion_rate"],
        "hp_completion_rate": r["hp_completion_rate"],
        "hp_failure_rate": r["hp_failure_rate"],
        "preemption_rate": r["hp_preemption_rate"],
        "lp_completion_rate": r["lp_completion_rate"],
        "lp_placed_rate": r["lp_completion_rate"],
        "four_core_fraction": r["four_core_fraction"],
        "lp_spawned": s["lp_spawned"],
        "lp_completed": s["lp_completed"],
        "preemptions": s["hp_preempted"],
        "realloc_success": s["lp_requeued"],
        "missed_by_preemption": s["missed_by_preemption"],
    }
    if reduce:
        view = {k: float(np.mean(v)) for k, v in view.items()}
    return view


def _serial_view(scenario: str, congestion: float, n_frames: int,
                 n_devices: int, seeds: Sequence[int]) -> dict:
    views = []
    for s in seeds:
        m = run_experiment(ExperimentConfig(
            scheduler="ras", trace=scenario, n_frames=n_frames,
            n_devices=n_devices, duty_cycle=congestion, seed=s,
        ))
        views.append(m.calib_view())
    return {k: float(np.mean([v[k] for v in views])) for k in views[0]}


def _fleet_point(scenario: str, congestion: float, n_frames: int,
                 n_devices: int, seeds: Sequence[int],
                 params: FleetParams, device) -> dict:
    # one replica column per matched seed — identical trace entries to the
    # serial runs, advanced together on the device
    values = np.stack(
        [generate_trace(scenario, n_frames, n_devices, seed=s).entries
         for s in seeds], axis=1,
    )                                                    # [F, S, Dev]
    bw = np.ones((n_frames, len(seeds)), np.float32)
    if congestion > 0.0:
        rng = np.random.default_rng(
            np.random.SeedSequence([hash_cell(scenario), seeds[0]])
        )
        bw = bw * _congestion_bursts(rng, n_frames, len(seeds), congestion)
    fleet = make_fleet(len(seeds), n_devices,
                       requeue_slots=params.requeue_slots, device=device)
    _, stats = fleet_run(fleet, values, bw, params=params)
    return fleet_view(stats)


def hash_cell(scenario: str) -> int:
    return zlib.crc32(scenario.encode()) & 0xFFFF


def run_point(scenario: str, congestion: float, *, n_frames: int = 95,
              n_devices: int = 4, seeds: Sequence[int] = (0,),
              params: Optional[FleetParams] = None, device=None) -> dict:
    """One matched cell: seed-averaged serial and fleet views + deltas.
    The fleet leg runs on ``device`` (``None`` -> CUDA)."""
    device = resolve_device(device)
    p = params or FleetParams(n_devices=n_devices)
    serial = _serial_view(scenario, congestion, n_frames, n_devices, seeds)
    fleet = _fleet_point(scenario, congestion, n_frames, n_devices, seeds, p,
                         device)
    delta = {k: round(fleet[k] - serial[k], 4) for k in DELTA_KEYS}
    return {
        "serial": {k: round(v, 4) for k, v in serial.items()},
        "fleet": {k: round(v, 4) for k, v in fleet.items()},
        "delta": delta,
        "max_abs_delta": round(max(abs(v) for v in delta.values()), 4),
    }


def run_calibration(cfg: CalibConfig, *, device=None) -> dict:
    """All cells of the (scenario × congestion) grid, the fleet legs on
    ``device`` (``None`` -> CUDA, raising where there is none)."""
    device = resolve_device(device)
    seeds = tuple(cfg.base_seed + i for i in range(cfg.n_seeds))
    cells = {}
    for scen in cfg.scenarios:
        if scen not in PAPER_TRACES:
            raise ValueError(
                f"calibration needs a paper trace family {PAPER_TRACES}, "
                f"got {scen!r} (the serial DES cannot replay it)"
            )
        for cong in cfg.congestion_levels:
            cells[f"{scen}@{cong:g}"] = run_point(
                scen, float(cong), n_frames=cfg.n_frames,
                n_devices=cfg.n_devices, seeds=seeds,
                params=cfg.fleet_params(), device=device,
            )
    return {
        "_config": {
            "scenarios": list(cfg.scenarios),
            "congestion_levels": [float(c) for c in cfg.congestion_levels],
            "n_seeds": cfg.n_seeds,
            "n_frames": cfg.n_frames,
            "n_devices": cfg.n_devices,
            "delta_keys": list(DELTA_KEYS),
        },
        "cells": cells,
    }
