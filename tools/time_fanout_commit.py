#!/usr/bin/env python3
"""Time ``fanout_commit`` (the fleet's HP commit kernel) of several source
trees on one card, on the same inputs and by the same measure as
``chip_smoke.py``.

    python3 tools/time_fanout_commit.py LABEL=TREE [LABEL=TREE ...]

TREE is a checkout (or a ``git archive``) whose ``src/repro_torch`` holds a
placement library with ``fanout_commit``; this repo is ``.``. Each tree
runs in a process of its own, in the order given (parent, change, change,
parent compares two trees within one call): its library is built from its
own source, its kernel held bit for bit to ``tensor_state.fanout_commit``
on the timing case (``chip_smoke.big_hp_case``: B 524,288, the benchmark's
fleet batch, every row committing on device 1, the hand-built HP rows
first, made from a fixed seed by the tree's ``cases``), then timed by
chip_smoke.py's ``time_fanout_commit``: device time cold (L2 flushed) and
warm, the plain version's time, the byte bound. Every line is JSON; a
tree's last is ``{"tree": LABEL, ...}`` with its timing row and ptxas's
registers. Exits non-zero without CUDA, or when a tree fails to build or
differs from its plain version.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
from _trees import exit_if_failed, import_tree, parse_trees, run_trees

SEED, DEVICE = 18, 1


def child(label: str, tree: Path) -> None:
    smoke, package = import_tree(label, tree)
    from repro_torch.kernels import _build
    from repro_torch.kernels.placement import placement
    from repro_torch.kernels.placement.cases import HP

    dev = torch.device("cuda")
    logs = _build.build(["placement"])
    ptxas = smoke.ptxas_report(logs, ("fanout_commit_kernel",))
    case = smoke.big_hp_case(smoke.HP_COMMIT_B, seed=SEED, dev=DEVICE,
                             do_rate=1.0)
    ref = smoke.plain_fanout_commit(smoke.to_card(case, dev), DEVICE)
    xs = smoke.to_card(case, dev)
    ker = placement.fanout_commit(*xs[:4], DEVICE, HP, *xs[4:])
    same = [smoke.bit_equal(r, k) for r, k in zip(ref, ker)]
    smoke.check(all(same), f"{label}: fanout_commit differs from its "
                           f"plain version: {same}")
    del ref, xs, ker
    row = smoke.time_fanout_commit(dev, case, DEVICE)
    smoke.emit({"tree": label, "path": str(tree),
                "package": str(package), **row,
                "outputs_bit_identical": same, "ptxas": ptxas,
                "from_cache": not logs})


def main() -> None:
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], Path(sys.argv[3]).resolve())
        return
    trees = parse_trees(__file__, __doc__)
    exit_if_failed(__file__, run_trees(__file__, trees))


if __name__ == "__main__":
    main()
