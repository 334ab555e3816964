"""Monte-Carlo sweeps: seed × scenario × congestion grids run as batches.

`run_sweep` flattens the grid into replicas (cell = scenario × congestion,
`n_seeds` replicas per cell), packs replicas into fixed-size batches, runs
each batch through `fleet_run` and reduces each cell's slice to mean ± 95%
CI statistics on the host. There is no Python loop over replicas — only
over batches, each of which advances up to `batch_size` replicas at once.

Sharded sweeps (``mesh_shards >= 1``): each batch is split across the
shards' devices (``fleet/mesh.py``) and reduced to per-cell rate moments
*on the device* (``metrics.cell_moments``), so the host receives O(cells
× metrics) floats per batch instead of `[B]` counter arrays and never
sees the O(B·state) window buffers. Batch moments fold into a running
total via the parallel-variance merge (float64, on the host); the
per-cell summaries carry the same keys as the host path (including the
checked conservation residual, whose ``max_abs`` must be 0 on every
trace).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.fleet import mesh as _mesh
from repro_torch.fleet.engine import FleetParams, fleet_run
from repro_torch.fleet.metrics import (
    FleetStats, cell_moments, cell_rate_keys, merge_cell_moments,
    stats_to_numpy, summarize, summarize_cells,
)
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
    #: split every batch across this many devices and reduce metrics on
    #: the device (0 = unsharded host-side reduction).
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
    device = resolve_device(device)
    if cfg.mesh_shards:
        return _run_sweep_sharded(cfg, device)
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


# ---------------------------------------------------------------------------
# sharded path: on-device per-cell reduction, O(metrics) host transfer
# ---------------------------------------------------------------------------

def _run_sweep_sharded(cfg: SweepConfig, device) -> dict:
    p = cfg.fleet_params()
    shards = p.mesh_shards
    cells, values, bw_scale, owners = _build_population(cfg)
    total = values.shape[1]

    # batch size must split across the shards; pad the tail with
    # owner=-1 replicas, which the on-device reduction excludes
    bs = min(cfg.batch_size, total) if total else cfg.batch_size
    bs += _mesh.shard_pad(bs, shards)
    pad = (-total) % bs
    if pad:
        values = np.concatenate([values, values[:, :pad]], axis=1)
        bw_scale = np.concatenate([bw_scale, bw_scale[:, :pad]], axis=1)
        owners = np.concatenate([owners, np.full((pad,), -1, np.int32)])

    moments = None
    for b0 in range(0, values.shape[1], bs):
        fleet = make_fleet(bs, cfg.n_devices, requeue_slots=p.requeue_slots,
                           device=device)
        state, stats = fleet_run(
            fleet,
            values[:, b0:b0 + bs],
            bw_scale[:, b0:b0 + bs],
            params=p,
        )
        owner = torch.as_tensor(owners[b0:b0 + bs], device=device)
        batch_moments = cell_moments(
            stats, state.rq_valid, owner, n_cells=len(cells),
            n_frames=cfg.n_frames, shards=shards,
        )
        # the one host transfer per batch: [C] + 2×[C, K] + [C] moments
        moments = merge_cell_moments(moments, batch_moments)

    keys = cell_rate_keys()
    summaries = summarize_cells(moments, keys)
    out = {
        "_sweep": {
            "cells": [f"{s}@{c:g}" for s, c in cells],
            "n_seeds": cfg.n_seeds,
            "n_frames": cfg.n_frames,
            "total_replicas": int(total),
            "batch_size": bs,
            "mesh": {
                "shards": shards,
                "replicas_per_shard": bs // shards,
                "reduction": "on-device (summed over shards, O(cells x "
                             "metrics) host transfer)",
            },
        }
    }
    for ci, (scen, cong) in enumerate(cells):
        out[f"{scen}@{cong:g}"] = summaries[ci]
    return out
