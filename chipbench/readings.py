"""The readings that a cell's check limits are set from, in one process:
the program on many seeds (the lower readings) and the control, the
plain reference put in the program's place in the precision below the
one the configuration states, on a few (the upper readings).

    python3 chipbench/readings.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 1

Each run prints one JSON line: the seed, which side ran, and every
number compared. The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    from chipbench import harness

    harness._caches(harness.ROOT)
    runs = [(int(s), None) for s in args.seeds.split(",") if s] + [
        (int(s), "control") for s in args.control_seeds.split(",") if s]
    for seed, program in runs:
        t = time.perf_counter()
        line = harness.run_cell(harness.ROOT, args.workload, seed=seed,
                                seconds=args.seconds, trace=False,
                                device="cuda", t_start=t, program=program)
        print(json.dumps({
            "seed": seed, "side": program or "program",
            "correct": line["correct"], "attempted": line["attempted"],
            "failed": line["failed"],
            "checks": {k: v["value"] for k, v in line["checks"].items()},
            "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    _root = Path(__file__).resolve().parent.parent
    for _p in (str(_root / "src"), str(_root)):
        if _p not in sys.path:
            sys.path.insert(0, _p)
    sys.exit(main())
