#!/usr/bin/env python3
"""Time ``fused_place`` of several source trees on one card, on the same
inputs and by the same measure as ``chip_smoke.py``.

    python3 tools/time_fused_place.py LABEL=TREE [LABEL=TREE ...]

TREE is a checkout (or a ``git archive``) whose ``src/repro_torch`` holds a
placement library; this repo is ``.``. Each tree runs in a process of its
own, in the order given (parent, change, change, parent compares two trees
within one call): its library is built from its own source, held bit for
bit to its plain version on chip_smoke.py's fleet case (B 8192 with the
hand-built rows, made once by this repo's ``cases`` so that every tree gets
the same rows), then timed by chip_smoke.py's ``time_fused_place``: device
time cold (L2 flushed) and warm, the plain version's time, the bound. Every
line is JSON; a tree's last is ``{"tree": LABEL, ...}`` with its timing row
and ptxas's registers. Exits non-zero without CUDA, or when a tree fails to
build or differs from its plain version.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
from _trees import ROOT, exit_if_failed, import_tree, parse_trees, run_trees


def child(label: str, tree: Path, inputs: Path) -> None:
    smoke, package = import_tree(label, tree)
    from repro_torch.kernels import _build
    from repro_torch.kernels.placement import placement
    from repro_torch.kernels.placement.ref import fused_place_ref

    dev = torch.device("cuda")
    logs = _build.build(["placement"])
    ptxas = smoke.ptxas_report(logs, ("fused_place_kernel",))
    with np.load(inputs) as z:
        case = [z[f"a{i}"] for i in range(len(z.files))]
    ref = fused_place_ref(*smoke.to_card(case, dev))
    ker = placement.fused_place(*smoke.to_card(case, dev))
    same = [smoke.bit_equal(r, k) for r, k in zip(ref, ker)]
    smoke.check(all(same), f"{label}: fused_place differs from its plain "
                           f"version: {same}")
    row = smoke.time_fused_place(dev, case)
    smoke.emit({"tree": label, "path": str(tree),
                "package": str(package), **row,
                "outputs_bit_identical": same, "ptxas": ptxas,
                "from_cache": not logs})


def main() -> None:
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], Path(sys.argv[3]).resolve(), Path(sys.argv[4]))
        return
    trees = parse_trees(__file__, __doc__)
    import chip_smoke as smoke

    case = smoke.fused_place_cases()[0][1]
    inputs = ROOT / "build" / "time_fused_place_inputs.npz"
    inputs.parent.mkdir(exist_ok=True)
    np.savez(inputs, **{f"a{i}": x for i, x in enumerate(case)})
    try:
        failed = run_trees(__file__, trees, str(inputs))
    finally:
        inputs.unlink(missing_ok=True)
    exit_if_failed(__file__, failed)


if __name__ == "__main__":
    main()
