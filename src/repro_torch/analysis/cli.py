"""Launch geometry check of every registered CUDA launch of the port, one
report, one exit code.

    PYTHONPATH=src python -m repro_torch.analysis                 # must pass
    PYTHONPATH=src python -m repro_torch.analysis --fixture race  # must fail
    REPRO_ANALYSIS_FIXTURE=oob,alias python -m repro_torch.analysis

Prints the report, writes it to ``results/analysis/analysis_report.json``
(``--report-dir``; '' writes nothing) and exits 1 on any violation.
Fixtures come from ``--fixture`` and from the comma-separated
``REPRO_ANALYSIS_FIXTURE``, merged. The geometry part of the JAX package's
``analysis/cli.py``; its ``jaxlint`` pass is specific to JAX and XLA and
has no counterpart, so the report has no ``lint`` key.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis import launch_check
from repro_torch.analysis.fixtures import GEOMETRY_FIXTURES


ENV_FIXTURE = "REPRO_ANALYSIS_FIXTURE"


def env_fixtures() -> tuple[str, ...]:
    """The fixtures named in ``REPRO_ANALYSIS_FIXTURE`` (comma-separated)."""
    raw = os.environ.get(ENV_FIXTURE, "")
    return tuple(f for f in (s.strip() for s in raw.split(",")) if f)


def run_analysis(fixtures: tuple[str, ...] = (), *,
                 report_dir: str = "results/analysis") -> dict:
    """The report over the production registry plus the named fixtures
    (keys ``ok``, ``fixtures``, ``geometry``), written to
    ``report_dir/analysis_report.json`` unless ``report_dir`` is ''."""
    unknown = sorted(set(fixtures) - set(GEOMETRY_FIXTURES))
    if unknown:
        raise ValueError(f"unknown fixture(s) {unknown}; known: "
                         f"{list(GEOMETRY_FIXTURES)}")
    providers = dict(launch_check.load_registry())
    if fixtures:
        from repro_torch.analysis.fixtures.racy_kernel import (
            GEOMETRY_PROVIDERS,
        )
        for f in fixtures:
            providers[f"fixture_{f}"] = GEOMETRY_PROVIDERS[f]
    geometry = launch_check.check_all(providers)
    report = {"ok": bool(geometry["ok"]), "fixtures": list(fixtures),
              "geometry": geometry}
    if report_dir:
        os.makedirs(report_dir, exist_ok=True)
        with open(os.path.join(report_dir, "analysis_report.json"), "w") as f:
            json.dump(report, f, indent=1)
    return report


def print_report(report: dict) -> None:
    geo = report["geometry"]
    points = sum(k["grid_points_checked"] for k in geo["kernels"].values())
    print(f"launch geometry: {geo['n_kernels']} kernels, {points} blocks, "
          f"{geo['n_violations']} violation(s)")
    for name, k in geo["kernels"].items():
        print(f"  {name}: {len(k['cases'])} case(s), "
              f"{k['grid_points_checked']} blocks")
    for v in geo["violations"]:
        print(f"  [{v['kind']}] {v['kernel']}/{v['case']}: {v['detail']}")
    print("analysis:", "OK" if report["ok"] else "FAILED")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--fixture", action="append", default=[],
                    choices=list(GEOMETRY_FIXTURES), metavar="NAME",
                    help="include a seeded-violation fixture "
                         f"({', '.join(GEOMETRY_FIXTURES)}); repeatable")
    ap.add_argument("--report-dir", default="results/analysis",
                    help="where to write analysis_report.json "
                         "('' disables)")
    args = ap.parse_args(argv)
    fixtures = tuple(dict.fromkeys((*args.fixture, *env_fixtures())))
    report = run_analysis(fixtures, report_dir=args.report_dir)
    print_report(report)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
