"""Launch geometry check of every registered CUDA launch of the port, one
report, one exit code.

    PYTHONPATH=src python -m repro_torch.analysis                 # must pass
    PYTHONPATH=src python -m repro_torch.analysis --fixture race  # must fail

Prints the report and exits 1 on any violation. The geometry part of the
JAX package's ``analysis/cli.py``; its ``jaxlint`` pass is specific to JAX
and XLA and has no counterpart.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import launch_check
from repro_torch.analysis.fixtures import GEOMETRY_FIXTURES


def run_analysis(fixtures: tuple[str, ...] = ()) -> dict:
    """The checker's report over the production registry plus the named
    fixtures (key ``ok``)."""
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
    return launch_check.check_all(providers)


def print_report(report: dict) -> None:
    points = sum(k["grid_points_checked"] for k in report["kernels"].values())
    print(f"launch geometry: {report['n_kernels']} kernels, {points} blocks, "
          f"{report['n_violations']} violation(s)")
    for name, k in report["kernels"].items():
        print(f"  {name}: {len(k['cases'])} case(s), "
              f"{k['grid_points_checked']} blocks")
    for v in report["violations"]:
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
    args = ap.parse_args(argv)
    report = run_analysis(tuple(dict.fromkeys(args.fixture)))
    print_report(report)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
