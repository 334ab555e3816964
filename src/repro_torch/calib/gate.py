"""Tolerance gate: turn a calibration report into a CI pass/fail.

The committed tolerance file (results/calib/baseline.json) holds one
absolute tolerance per compared rate, plus optional per-congestion
overrides:

    {
      "tolerances": {"frame_completion_rate": 0.15, ...},
      "overrides": {"@0.3": {"frame_completion_rate": 0.3, ...}},
      "generated_from": {...provenance...},
      "note": "..."
    }

``check_report`` fails a report when any cell's |delta| exceeds its
metric's tolerance; a cell named ``<scenario>@<congestion>`` picks up the
override table whose key suffixes its name.  Congestion-0 cells replay
byte-identical traces through both engines, so their bands are tight (the
B=1 equivalence claim); congested cells compare two different stochastic
bandwidth processes and carry wider bands.  A metric absent from the
tolerance table is not gated (reported only), so new diagnostics can land
before being enforced.

Re-baselining (after an intentional fidelity change): run the harness,
then ``write_baseline(report, path)`` — tolerances are set to the largest
observed |delta| per metric times a slack factor, floored so sampling
noise between CI runs does not flap the gate.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional

#: Default location of the committed tolerance file, relative to the repo
#: root (CI and benchmarks.run both execute from the repo root).
DEFAULT_BASELINE = os.path.join("results", "calib", "baseline.json")
DEFAULT_REPORT = os.path.join("results", "calib", "calib_report.json")

#: Re-baselining knobs: observed-delta multiplier and absolute floor.
BASELINE_SLACK = 1.6
BASELINE_FLOOR = 0.02


def load_baseline(path: Optional[str] = None) -> dict:
    with open(path or DEFAULT_BASELINE) as f:
        base = json.load(f)
    if "tolerances" not in base:
        raise ValueError(f"baseline file {path!r} has no 'tolerances' table")
    return base


def save_report(report: dict, path: Optional[str] = None) -> str:
    path = path or DEFAULT_REPORT
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    return path


def _cell_tolerances(cell: str, baseline: dict) -> dict:
    tol = dict(baseline["tolerances"])
    for suffix, over in baseline.get("overrides", {}).items():
        if cell.endswith(suffix):
            tol.update(over)
    return tol


def check_report(report: dict, baseline: dict) -> tuple[bool, list[str]]:
    """Returns (ok, failures); each failure names cell, metric, delta and
    the tolerance it broke."""
    failures = []
    for cell, point in sorted(report["cells"].items()):
        for metric, bound in sorted(_cell_tolerances(cell, baseline).items()):
            if metric not in point["delta"]:
                continue
            d = point["delta"][metric]
            if abs(d) > bound:
                failures.append(
                    f"{cell}: |{metric} delta| = {abs(d):.4f} > "
                    f"tolerance {bound:.4f}"
                )
    return (not failures), failures


def _group_tolerances(cells: dict, metrics, slack: float,
                      floor: float) -> dict:
    tol = {}
    for m in metrics:
        worst = max(abs(point["delta"][m]) for point in cells.values())
        # round up at 3 decimals so the committed file is stable and readable
        tol[m] = max(floor, math.ceil(worst * slack * 1000) / 1000)
    return tol


def write_baseline(report: dict, path: Optional[str] = None, *,
                   slack: float = BASELINE_SLACK,
                   floor: float = BASELINE_FLOOR) -> dict:
    """Derive tolerances from a report's observed deltas and write them.

    Cells are grouped by their ``@<congestion>`` suffix: the zero-
    congestion group defines the base table (the matched-trace equivalence
    bands); every other congestion level becomes an override entry."""
    metrics = report["_config"]["delta_keys"]
    groups: dict[str, dict] = {}
    for cell, point in report["cells"].items():
        suffix = "@" + cell.rsplit("@", 1)[1]
        groups.setdefault(suffix, {})[cell] = point
    base_group = groups.pop("@0", None) or groups.pop(
        min(groups, key=lambda s: float(s[1:])), None
    )
    base = {
        "tolerances": _group_tolerances(base_group, metrics, slack, floor),
        "overrides": {
            sfx: _group_tolerances(cells, metrics, slack, floor)
            for sfx, cells in sorted(groups.items())
        },
        "generated_from": report["_config"],
        "note": (
            "fleet-vs-serial |delta| bound per metric; congestion-0 cells "
            "replay matched traces (tight bands), 'overrides' widen them "
            "for congested cells; re-baseline with `python -m "
            "benchmarks.bench_calib --rebaseline` after an intentional "
            "fidelity change"
        ),
    }
    path = path or DEFAULT_BASELINE
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(base, f, indent=1, sort_keys=True)
    return base
