"""What the ``tools/time_*.py`` comparisons of source trees share.

Each such tool runs one child process a tree, in the order given on its
command line (``LABEL=TREE ...``; parent, change, change, parent compares
two trees within one call). A child imports the tree's own package by
``import_tree`` and times it; the parent process parses the trees, prints
the card's name and power limit (``parse_trees``) and runs the children
(``run_trees``).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def import_tree(label: str, tree: Path):
    """Import ``tree``'s ``repro_torch``, then this repo's ``chip_smoke``
    (which puts this repo's ``src`` first on the path, so the tree's
    package is imported before it). Returns the ``chip_smoke`` module and
    the package's directory; exits non-zero if the package is not the
    tree's."""
    sys.path.insert(0, str(tree / "src"))
    import repro_torch

    sys.path.insert(1, str(ROOT))
    import chip_smoke as smoke

    package = Path(repro_torch.__file__).resolve().parent
    smoke.check(package.is_relative_to(tree),
                f"{label}: imported {package}, not the tree's package")
    return smoke, package


def parse_trees(script: str, doc: str) -> list[list[str]]:
    """The parent process of ``script``: exits non-zero without CUDA, or
    with ``doc`` on a bad command line; prints the card's line and returns
    the ``[LABEL, TREE]`` pairs."""
    name = Path(script).stem
    if not torch.cuda.is_available():
        print(f"{name}: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    trees = [a.split("=", 1) for a in sys.argv[1:]]
    if not trees or any(len(t) != 2 for t in trees):
        print(doc, file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    print(smoke.smi_line(), flush=True)
    return trees


def run_trees(script: str, trees: list[list[str]], *extra: str) -> list[str]:
    """Runs ``script --child LABEL TREE *extra`` for each tree in turn.
    Returns the labels whose child failed."""
    failed = []
    for label, tree in trees:
        print(json.dumps({"start": label, "path": tree}), flush=True)
        if subprocess.run([sys.executable, script, "--child", label, tree,
                           *extra]).returncode:
            failed.append(label)
    return failed


def exit_if_failed(script: str, failed: list[str]) -> None:
    if failed:
        print(f"{Path(script).stem}: failed: {failed}", file=sys.stderr)
        sys.exit(1)
