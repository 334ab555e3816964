"""Fleet-vs-serial calibration harness.

Runs matched (seed, scenario, congestion) points through both the serial
discrete-event simulator (sim/) and the batched fleet engine (fleet/, on
the card unless the caller names another device), reduces each side to a
shared set of rates, and reports per-scenario deltas. gate.py turns the
committed tolerance file (results/calib/baseline.json) into a pass/fail
gate.
"""

from repro_torch.calib.gate import (
    check_report,
    load_baseline,
    save_report,
    write_baseline,
)
from repro_torch.calib.harness import (
    CalibConfig,
    fleet_view,
    run_calibration,
    run_point,
)

__all__ = [
    "CalibConfig",
    "check_report",
    "fleet_view",
    "load_baseline",
    "run_calibration",
    "run_point",
    "save_report",
    "write_baseline",
]
