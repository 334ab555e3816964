#!/usr/bin/env python3
"""Time ``flash_attention`` of several source trees on one card, at
``chip_smoke.py``'s attention cases and by its measure.

    python3 tools/time_attention.py LABEL=TREE [LABEL=TREE ...]

TREE is a checkout (or a ``git archive``) whose ``src/repro_torch`` holds
the attention library; this repo is ``.``. Each tree runs in a process of
its own, in the order given (parent, change, change, parent compares two
trees within one call): its library is built from its own source, each of
chip_smoke.py's ``ATTN_CASES`` (whole sequences, no query offset, so that
a tree without one runs them too; the inputs seeded as chip_smoke.py seeds
them) is held to the tree's plain version within ``ATTN_TOL`` and timed
by chip_smoke.py's ``time_ms`` (CUDA events, a warm loop: where a launch
is shorter than the host's cost a call, that cost) and ``device_ms`` (the
profiler's device time of the kernel alone). Every line is JSON; a tree's
last is ``{"tree": LABEL, ...}`` with its ms a launch by case, by both
measures, and ptxas's registers and spills of both kernels. Exits non-zero
without CUDA, or when a tree fails to build or differs from its plain
version.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
from _trees import exit_if_failed, import_tree, parse_trees, run_trees


def child(label: str, tree: Path) -> None:
    smoke, package = import_tree(label, tree)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    logs = _build.build(["flash_attention"])
    ptxas = smoke.ptxas_report(logs, ("flash_attention_kernel",
                                      "flash_attention_wgmma_kernel"))
    ms, device, errs = {}, {}, {}
    for i, c in enumerate(smoke.ATTN_CASES):
        name, *_, dt, causal, window, cap = c
        q, k, v = smoke.attn_inputs(i, c, dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        errs[name] = smoke.max_abs_err([attention_ref(q, k, v, **kw)],
                                       [fa.flash_attention(q, k, v, **kw)])
        smoke.check(errs[name] <= smoke.ATTN_TOL[dt],
                    f"{label}: {name} differs from the plain version by "
                    f"{errs[name]}")
        ms[name] = smoke.time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        device[name] = smoke.device_ms(
            lambda: fa.flash_attention(q, k, v, **kw), "flash_attention")[0]
        del q, k, v
    smoke.emit({"tree": label, "path": str(tree),
                "package": str(package), "ms": ms, "device_ms": device,
                "max_abs_err": errs, "ptxas": ptxas,
                "from_cache": not logs})


def main() -> None:
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], Path(sys.argv[3]).resolve())
        return
    trees = parse_trees(__file__, __doc__)
    exit_if_failed(__file__, run_trees(__file__, trees))


if __name__ == "__main__":
    main()
