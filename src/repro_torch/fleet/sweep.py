"""Monte-Carlo sweeps: seed × scenario × congestion grids run as batches.

`run_sweep` flattens the grid into replicas (cell = scenario × congestion,
`n_seeds` replicas per cell), packs replicas into fixed-size batches, runs
each batch through `fleet_run` and reduces each cell's slice to mean ± 95%
CI statistics on the host. There is no Python loop over replicas — only
over batches, each of which advances up to `batch_size` replicas at once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.fleet.engine import FleetParams, fleet_run
from repro_torch.fleet.metrics import FleetStats, stats_to_numpy, summarize
from repro_torch.fleet.scenarios import make_workload
from repro_torch.fleet.state import make_fleet


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    scenarios: Sequence[str] = ("uniform", "weighted2")
    congestion_levels: Sequence[float] = (0.0, 0.3)
    n_seeds: int = 64                 # replicas per (scenario, congestion)
    n_frames: int = 95
    n_devices: int = 4
    batch_size: int = 256             # replicas advanced per fleet_run
    base_seed: int = 0
    #: sharded sweeps are not ported yet; must stay 0.
    mesh_shards: int = 0
    params: Optional[FleetParams] = None

    def fleet_params(self) -> FleetParams:
        p = self.params if self.params is not None else FleetParams(
            n_devices=self.n_devices
        )
        if self.mesh_shards and p.mesh_shards != self.mesh_shards:
            p = dataclasses.replace(p, mesh_shards=self.mesh_shards)
        return p


def _cells(cfg: SweepConfig):
    for scen in cfg.scenarios:
        for cong in cfg.congestion_levels:
            yield scen, float(cong)


def _build_population(cfg: SweepConfig):
    """Host-side workload for the whole grid: each cell contributes
    n_seeds replica columns keyed by (base_seed, scenario, congestion)."""
    cells = list(_cells(cfg))
    vals, bws, owners = [], [], []
    for ci, (scen, cong) in enumerate(cells):
        wl = make_workload(
            scen, cfg.n_seeds, cfg.n_frames, cfg.n_devices,
            seed=cfg.base_seed + ci, congestion=cong,
        )
        vals.append(wl.values)
        bws.append(wl.bw_scale)
        owners.extend([ci] * cfg.n_seeds)
    values = np.concatenate(vals, axis=1)          # [F, Btot, Dev]
    bw_scale = np.concatenate(bws, axis=1)         # [F, Btot]
    return cells, values, bw_scale, np.asarray(owners, np.int32)


def run_sweep(cfg: SweepConfig, *, device=None) -> dict:
    """Returns {"scenario@congestion": summary} plus a "_sweep" header.
    Runs on ``device`` (``None`` -> CUDA)."""
    if cfg.mesh_shards:
        raise NotImplementedError(
            "mesh_shards: the sharded sweep is not ported yet")
    device = resolve_device(device)
    p = cfg.fleet_params()
    cells, values, bw_scale, owners = _build_population(cfg)
    total = values.shape[1]

    # fixed-size batches: the tail is padded with copies of the first
    # replicas, which are dropped on reduction
    bs = min(cfg.batch_size, total) if total else cfg.batch_size
    pad = (-total) % bs
    if pad:
        values = np.concatenate([values, values[:, :pad]], axis=1)
        bw_scale = np.concatenate([bw_scale, bw_scale[:, :pad]], axis=1)
    per_replica: list[FleetStats] = []
    per_replica_pending: list[np.ndarray] = []
    for b0 in range(0, values.shape[1], bs):
        fleet = make_fleet(bs, cfg.n_devices, requeue_slots=p.requeue_slots,
                           device=device)
        state, stats = fleet_run(
            fleet,
            values[:, b0:b0 + bs],
            bw_scale[:, b0:b0 + bs],
            params=p,
        )
        per_replica.append(stats_to_numpy(stats))
        # end-of-run re-queue occupancy: closes the LP conservation
        # identity that summarize() checks per cell
        per_replica_pending.append(
            state.rq_valid.sum(1).cpu().numpy().astype(np.int64)
        )
    merged = FleetStats(*(
        np.concatenate([getattr(s, f) for s in per_replica])[:total]
        for f in FleetStats._fields
    ))
    pending = np.concatenate(per_replica_pending)[:total]

    out = {
        "_sweep": {
            "cells": [f"{s}@{c:g}" for s, c in cells],
            "n_seeds": cfg.n_seeds,
            "n_frames": cfg.n_frames,
            "total_replicas": int(total),
            "batch_size": bs,
        }
    }
    for ci, (scen, cong) in enumerate(cells):
        sel = owners == ci
        cell_stats = FleetStats(
            *(getattr(merged, f)[sel] for f in FleetStats._fields)
        )
        out[f"{scen}@{cong:g}"] = summarize(
            cell_stats, cfg.n_frames, rq_pending=pending[sel]
        )
    return out
