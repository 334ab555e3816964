"""Batched Monte-Carlo fleet simulator (see engine.py for the contract)."""

from repro_torch.fleet.engine import FleetParams, fleet_run
from repro_torch.fleet.metrics import FleetStats, init_stats, summarize
from repro_torch.fleet.scenarios import Workload, make_workload, scenario_names
from repro_torch.fleet.state import (
    FleetState, broadcast_state, make_fleet, stack_states,
)
from repro_torch.fleet.sweep import SweepConfig, run_sweep

__all__ = [
    "FleetParams",
    "FleetState",
    "FleetStats",
    "SweepConfig",
    "Workload",
    "broadcast_state",
    "fleet_run",
    "init_stats",
    "make_fleet",
    "make_workload",
    "run_sweep",
    "scenario_names",
    "stack_states",
    "summarize",
]
