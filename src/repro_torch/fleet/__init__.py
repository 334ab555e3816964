"""Batched Monte-Carlo fleet simulator (see engine.py for the contract)."""

from repro_torch.fleet.engine import FleetParams, fleet_run
from repro_torch.fleet.mesh import (
    FLEET_AXIS, available_shards, fleet_devices, shard_pad,
)
from repro_torch.fleet.metrics import (
    CellMoments, FleetStats, cell_moments, cell_rate_keys, init_stats,
    merge_cell_moments, summarize, summarize_cells,
)
from repro_torch.fleet.scenarios import Workload, make_workload, scenario_names
from repro_torch.fleet.state import (
    FleetState, broadcast_state, make_fleet, stack_states,
)
from repro_torch.fleet.sweep import SweepConfig, run_sweep

__all__ = [
    "CellMoments",
    "FLEET_AXIS",
    "FleetParams",
    "FleetState",
    "FleetStats",
    "SweepConfig",
    "Workload",
    "available_shards",
    "broadcast_state",
    "cell_moments",
    "cell_rate_keys",
    "fleet_devices",
    "fleet_run",
    "init_stats",
    "make_fleet",
    "make_workload",
    "merge_cell_moments",
    "run_sweep",
    "scenario_names",
    "shard_pad",
    "stack_states",
    "summarize",
    "summarize_cells",
]
