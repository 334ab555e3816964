"""Run one cell of the benchmark once and print its result line:

    python3 chipbench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

(or ``python3 -m chipbench.run`` from the root of the checkout)."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    _root = Path(__file__).resolve().parent.parent
    for _p in (str(_root / "src"), str(_root)):
        if _p not in sys.path:
            sys.path.insert(0, _p)
    from chipbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
