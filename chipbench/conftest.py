"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with a
tiny cell added as new files only, run on the port's plain path."""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TINY = "pi4-tiny.sweep-tiny"
TINY_MODEL = "qwen-tiny.prefill-tiny"


def _lists_of(root: Path, bench: dict, metrics: list, driver: str) -> list:
    """The ``metrics`` whose ``workloads`` list holds a cell that
    ``driver`` runs: a tiny cell of that driver reports what they
    report."""
    pkg = root / "chipbench"
    drivers = {w["name"]: json.loads(
        (pkg / "traffic" / f"{w['traffic']}.json").read_text())["driver"]
        for w in bench["workloads"]}
    return [m for m in metrics
            if any(drivers.get(w) == driver for w in m.get("workloads", ()))]


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
    for m in _lists_of(root, bench, bench["end_to_end"], traffic["driver"]):
        m["workloads"].append(TINY)
    if metric:
        bench["per_layer"].append({
            "name": metric, "unit": "ms", "better": "lower",
            "source": "program_span",
            "layer": "fleet.engine tick on the card",
            "moves": "replica_frames_per_s", "workloads": [TINY]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return TINY


def add_tiny_model_cell(root: Path) -> str:
    """Add a tiny dense decoder (qwen2.5-3b's file at small widths), a
    tiny prefill mix and their cell to the benchmark under ``root``, by
    new files and ``BENCHMARK.json`` entries only; the cell joins every
    metric that lists a cell of the prefill driver."""
    pkg = root / "chipbench"
    config = json.loads((pkg / "configs" / "qwen2.5-3b.json").read_text())
    config.update(name="qwen-tiny", num_hidden_layers=8, hidden_size=64,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                  intermediate_size=128, vocab_size=512)
    (pkg / "configs" / "qwen-tiny.json").write_text(json.dumps(config))
    traffic = json.loads(
        (pkg / "traffic" / "prefill-mixed.json").read_text())
    traffic.update(prompts=16, block=8, median_tokens=24, min_tokens=8,
                   max_tokens=64, multiple=8, step_tokens=128,
                   sample_steps=4, sample_random=2, trace_steps=[2, 4])
    (pkg / "traffic" / "prefill-tiny.json").write_text(json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = next(c for c in bench["configs"] if c["name"] == "qwen2.5-3b")
    bench["configs"].append(dict(cfg, name="qwen-tiny",
                                 file="chipbench/configs/qwen-tiny.json"))
    cell = next(w for w in bench["workloads"]
                if w["name"] == "qwen2.5-3b.prefill-mixed")
    bench["workloads"].append(dict(cell, name=TINY_MODEL, config="qwen-tiny",
                                   traffic="prefill-tiny"))
    for m in _lists_of(root, bench, bench["end_to_end"] + bench["per_layer"],
                       traffic["driver"]):
        m["workloads"].append(TINY_MODEL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return TINY_MODEL


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


@pytest.fixture
def tiny_model(bench_copy):
    """``(root, workload)`` of a tiny prefill cell in a copy of the
    benchmark."""
    return bench_copy, add_tiny_model_cell(bench_copy)
