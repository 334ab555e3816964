"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with a
tiny cell added as new files only, run on the port's plain path."""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TINY = "pi4-tiny.sweep-tiny"


def add_tiny_cell(root: Path, metric: str | None = None) -> str:
    """Add a tiny configuration, traffic mix and cell to the benchmark
    under ``root`` (and a per-layer metric file, if named) by writing new
    files and ``BENCHMARK.json`` entries only."""
    pkg = root / "chipbench"
    config = json.loads((pkg / "configs" / "pi4-testbed.json").read_text())
    config.update(name="pi4-tiny", frames_per_replica=9, segment_frames=4)
    (pkg / "configs" / "pi4-tiny.json").write_text(json.dumps(config))
    traffic = json.loads((pkg / "traffic" / "sweep-heavy.json").read_text())
    traffic.update(replicas=8, distinct_batches=2, warmup_frames=2,
                   sample_per_group=1, trace_batch=0, trace_segment=1)
    (pkg / "traffic" / "sweep-tiny.json").write_text(json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="pi4-tiny",
                                 file="chipbench/configs/pi4-tiny.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name=TINY,
                                   config="pi4-tiny", traffic="sweep-tiny"))
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(TINY)
    if metric:
        bench["per_layer"].append({
            "name": metric, "unit": "ms", "better": "lower",
            "source": "program_span",
            "layer": "fleet.engine tick on the card",
            "moves": "replica_frames_per_s", "workloads": [TINY]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return TINY


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of ``BENCHMARK.json`` and the benchmark's package."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


@pytest.fixture
def tiny(bench_copy):
    """``(root, workload)`` of a tiny cell in a copy of the benchmark."""
    return bench_copy, add_tiny_cell(bench_copy)
