"""A cell made of new files alone is found and runs; a run that asks
for the card where there is none gives no result."""

import json
import time

import pytest
import torch

from chipbench import harness
from chipbench.conftest import add_tiny_cell


def test_a_cell_of_new_files_runs_on_the_plain_path(bench_copy):
    """A configuration, a traffic mix and a per-layer reader added as new
    files, and BENCHMARK.json entries, run on the CPU at a tiny size."""
    reader = bench_copy / "chipbench" / "metrics" / "tiny_probe_ms.py"
    reader.write_text("def read(ctx):\n    return None\n")
    cell = add_tiny_cell(bench_copy, metric="tiny_probe_ms")
    before = sorted(p.relative_to(bench_copy) for p in
                    (bench_copy / "chipbench").rglob("*") if p.is_file())
    line = harness.run_cell(bench_copy, cell, seed=2**31 + 3, seconds=0.01,
                            trace=False, device="cpu",
                            t_start=time.perf_counter())
    assert line["correct"] is True
    assert set(line["metrics"]) == {"replica_frames_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["attempted"] >= 8 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    spec = harness.cell_spec(bench_copy, cell)
    assert [m["name"] for m in spec["per_layer"]] == ["tiny_probe_ms"]
    after = sorted(p.relative_to(bench_copy) for p in
                   (bench_copy / "chipbench").rglob("*") if p.is_file())
    assert [p for p in after if p.suffix != ".pyc"] == [
        p for p in before if p.suffix != ".pyc"]


def test_the_same_seed_gives_the_same_inputs(tiny):
    from chipbench.drivers import fleet_sweep

    root, cell = tiny
    spec = harness.cell_spec(root, cell)
    a = fleet_sweep._inputs(spec["traffic"], spec["config"], 2**31 + 9)
    b = fleet_sweep._inputs(spec["traffic"], spec["config"], 2**31 + 9)
    c = fleet_sweep._inputs(spec["traffic"], spec["config"], 2**31 + 10)
    assert all((x[0] == y[0]).all() and (x[1] == y[1]).all()
               for x, y in zip(a, b))
    assert any((x[0] != y[0]).any() for x, y in zip(a, c))


def test_device_metrics_without_a_card_fail(tiny):
    """The traced run reads the card's profiler: on the host it raises
    instead of reporting a number."""
    root, cell = tiny
    if torch.cuda.is_available():
        pytest.skip("this test checks a machine without a card")
    with pytest.raises((RuntimeError, AssertionError)):
        harness.run_cell(root, cell, seed=1, seconds=0.01, trace=True,
                         device="cpu", t_start=time.perf_counter())


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "pi4-testbed.sweep-heavy", "--seed",
                       "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_too_few_cards_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = harness.main(["--workload", "pi4-testbed.sweep-heavy", "--seed",
                       "1", "--seconds", "1", "--trace", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_an_unknown_cell_no_result(capsys):
    rc = harness.main(["--workload", "no-such.cell", "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_benchmark_json_names_existing_files():
    root = harness.ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (root / c["file"]).is_file()
    for w in bench["workloads"]:
        spec = harness.cell_spec(root, w["name"])
        assert (root / "chipbench" / "drivers"
                / f"{spec['traffic']['driver']}.py").is_file()
    for m in bench["per_layer"]:
        assert (root / "chipbench" / "metrics" / f"{m['name']}.py").is_file()
