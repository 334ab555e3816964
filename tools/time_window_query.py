#!/usr/bin/env python3
"""Time the window-query kernels of several source trees on one card, on
the same inputs and by the same measure as ``chip_smoke.py``.

    python3 tools/time_window_query.py LABEL=TREE [LABEL=TREE ...]

TREE is a checkout (or a ``git archive``) whose ``src/repro_torch`` holds a
window-query library; this repo is ``.``. Each tree runs in a process of
its own, in the order given (parent, change, change, parent compares two
trees within one call): its library is built from its own source, both of
its entry points are held bit for bit to their plain versions at every case
of chip_smoke.py's ``wq_cases`` (seeded, so every tree gets the same
inputs), then every case is timed by chip_smoke.py's ``time_wq_case``:
device time cold (L2 flushed) and warm, the wrapper's and the plain
version's time a call, the byte bound. Last, the host's cost of one call of
``window_query_batched_op`` on the fleet's HP view (chip_smoke.py's
``host_us``). Every line is JSON; a tree's last is ``{"tree": LABEL,
"summary": ...}`` with each case's cold and warm µs, the host's µs a call
and ptxas's registers. Then, once, what reading the two large cases'
bytes costs one PyTorch ``sum`` cold and warm (``floor``). Exits non-zero
without CUDA, or when a tree fails to build or differs from its plain
version.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch
from _trees import ROOT, exit_if_failed, import_tree, parse_trees, run_trees


def child(label: str, tree: Path) -> None:
    smoke, package = import_tree(label, tree)
    from repro_torch.kernels import _build
    from repro_torch.kernels.window_query import window_query as wq
    from repro_torch.kernels.window_query.ops import window_query_batched_op

    dev = torch.device("cuda")
    logs = _build.build(["window_query"])
    ptxas = smoke.ptxas_report(logs, ("window_query_kernel",))
    cases = smoke.wq_cases(dev)
    fns = smoke.wq_fns()
    for case, entry, _, xs in cases:
        ker_fn, ref_fn = fns[entry]
        ker = ker_fn(*xs)
        torch.cuda.synchronize()
        same = [smoke.bit_equal(k, r) for k, r in zip(ker, ref_fn(*xs))]
        smoke.check(all(same), f"{label}: {entry} differs from its plain "
                               f"version in case {case}: {same}")
    # launches by route of the checks above (a tree before the routes has
    # no such counts)
    routes = {r: getattr(wq, f"launches_{r}", None) for r in ("vec",
                                                              "scalar")}
    flush = torch.empty(smoke.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    summary = {}
    for case, entry, route, xs in cases:
        row = smoke.time_wq_case(entry, xs, flush)
        smoke.emit({"tree": label, "case": case, "kernel": entry,
                    "route": route, **row})
        summary[case] = {"us_cold": 1e3 * row["ms"],
                         "us_warm": 1e3 * row["ms_warm"],
                         "share_of_bound": row["share_of_bound"]}
    fleet = next(xs for case, _, _, xs in cases
                 if case == "fleet-hp-view-8192")
    op_us = smoke.host_us({"op": lambda: window_query_batched_op(*fleet)})[
        "op"]
    smoke.emit({"tree": label, "path": str(tree),
                "package": str(package), "summary": summary,
                "outputs_bit_identical": True,
                "hp_query_op_host_us": op_us,
                "check_launches_by_route": routes,
                "ptxas": ptxas, "from_cache": not logs})


def floor() -> None:
    """What reading a case's bytes costs any kernel under the same cold
    protocol: the device time of one ``sum`` over a contiguous f32 buffer of
    the case's byte count (``wq_bound``'s bytes), cold (after the 64 MB
    write) and warm, by chip_smoke.py's ``device_ms``, for the two cases
    whose bytes can bind."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as smoke

    dev = torch.device("cuda")
    flush = torch.empty(smoke.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    for case, entry, _, xs in smoke.wq_cases(dev):
        if case not in ("batched-8192x4", "large-262144dev"):
            continue
        nbytes = smoke.wq_bound(xs, entry != "window_query")[3]
        buf = torch.ones(nbytes // 4, dtype=torch.float32, device=dev)

        def cold():
            flush.zero_()
            buf.sum()

        cold_ms, cold_seen = smoke.device_ms(cold, "reduce_kernel")
        warm_ms, warm_seen = smoke.device_ms(buf.sum, "reduce_kernel")
        smoke.emit({"floor": case, "bytes": nbytes, "what": "one sum over "
                    "a contiguous f32 buffer of the case's bytes",
                    "us_cold": 1e3 * cold_ms, "us_warm": 1e3 * warm_ms,
                    "device_events": {"cold": cold_seen, "warm": warm_seen}})


def main() -> None:
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], Path(sys.argv[3]).resolve())
        return
    if sys.argv[1:2] == ["--floor"]:
        floor()
        return
    trees = parse_trees(__file__, __doc__)
    failed = run_trees(__file__, trees)
    if subprocess.run([sys.executable, __file__, "--floor"]).returncode:
        failed.append("--floor")
    exit_if_failed(__file__, failed)


if __name__ == "__main__":
    main()
