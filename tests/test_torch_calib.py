"""The port's fleet-vs-serial calibration against the JAX package.

``calib/gate.py`` is a copy, pinned to its original. ``calib/harness.py``
is a port whose fleet leg is the port's fleet: on the CPU it is
bit-identical to the JAX package's and the serial leg is a copy of its
DES, so the two reports are equal exactly, dict for dict, at the
reference test's grid (the 5 paper traces, congestion 0, 1 seed, 40
frames) and at a congested grid of 2 seeds. Both pass the committed
``results/calib/baseline.json`` unchanged. The gate, override,
re-baseline, ``fleet_view`` and scenario cases of ``tests/test_calib.py``
are repeated against the port.
"""

import inspect
import os

import pytest
import torch

import repro.calib.gate as gate_j
import repro_torch.calib.gate as gate_t
from repro.calib import CalibConfig as CalibConfig_j
from repro.calib import run_calibration as run_calibration_j
from repro_torch.calib import (
    CalibConfig,
    check_report,
    load_baseline,
    run_calibration,
    write_baseline,
)
from repro_torch.calib.harness import DELTA_KEYS, PAPER_TRACES, fleet_view
from repro_torch.fleet import FleetParams
from repro_torch.fleet.metrics import init_stats
from repro_torch.sim.engine import ExperimentConfig, run_experiment

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO_ROOT, "results", "calib", "baseline.json")
N_FRAMES = 40
#: (scenarios, congestion levels, seeds) of the two compared grids
GRIDS = {
    "paper-traces@0": (PAPER_TRACES, (0.0,), 1),
    "two-traces@0.3x2": (PAPER_TRACES[:2], (0.3,), 2),
}


def _grid(name):
    scenarios, levels, seeds = GRIDS[name]
    return dict(scenarios=scenarios, congestion_levels=levels,
                n_seeds=seeds, n_frames=N_FRAMES)


@pytest.fixture(scope="module")
def reports():
    """Each grid's report from both packages, the port's on the CPU."""
    return {name: (run_calibration_j(CalibConfig_j(**_grid(name))),
                   run_calibration(CalibConfig(**_grid(name)), device="cpu"))
            for name in GRIDS}


@pytest.fixture(scope="module")
def calib_report(reports):
    return reports["paper-traces@0"][1]


def test_gate_copy_matches_its_original():
    assert (inspect.getsource(gate_t).replace("repro_torch", "repro")
            == inspect.getsource(gate_j))


@pytest.mark.parametrize("grid", GRIDS)
def test_report_equals_reference(reports, grid):
    ref, got = reports[grid]
    assert got == ref


@pytest.mark.parametrize("grid", GRIDS)
def test_report_passes_committed_baseline(reports, grid):
    ok, failures = check_report(reports[grid][1], load_baseline(BASELINE))
    assert ok, failures


def test_report_structure(calib_report):
    assert set(calib_report["cells"]) == {f"{t}@0" for t in PAPER_TRACES}
    for point in calib_report["cells"].values():
        assert set(point["delta"]) == set(DELTA_KEYS)
        for side in ("serial", "fleet"):
            for k in DELTA_KEYS:
                assert k in point[side]
        assert point["max_abs_delta"] >= 0


def test_gate_trips_when_tolerance_artificially_exceeded(calib_report):
    zero = {"tolerances": {k: 0.0 for k in DELTA_KEYS}}
    ok, failures = check_report(calib_report, zero)
    assert not ok
    # the preemption-model abstraction always leaves a non-zero residual
    assert any("preemption_rate" in f for f in failures)


def test_gate_overrides_widen_specific_cells(calib_report):
    zero = {"tolerances": {k: 0.0 for k in DELTA_KEYS},
            "overrides": {"@0": {k: 1.0 for k in DELTA_KEYS}}}
    ok, failures = check_report(calib_report, zero)
    assert ok, failures  # every cell here is @0, all widened to 1.0


def test_write_baseline_roundtrip(tmp_path, calib_report):
    path = str(tmp_path / "baseline.json")
    base = write_baseline(calib_report, path)
    assert set(base["tolerances"]) == set(DELTA_KEYS)
    ok, failures = check_report(calib_report, load_baseline(path))
    assert ok, failures  # tolerances derived from a report must admit it


def test_serial_calib_view_keys_and_ranges():
    view = run_experiment(
        ExperimentConfig(trace="uniform", n_frames=20, seed=3)).calib_view()
    for k in DELTA_KEYS:
        assert 0.0 <= view[k] <= 1.0  # every gated metric is a rate
    assert view["lp_placed_rate"] >= view["lp_completion_rate"]


def test_fleet_view_matches_stats():
    view = fleet_view(init_stats(3, device="cpu"))
    assert view["frames"] == 0
    assert view["frame_completion_rate"] == 0.0
    assert view["preemption_rate"] == 0.0


def test_plain_backend_gives_the_same_report(calib_report):
    """``placement_backend="ref"`` is the plain path the card's report is
    held to; on the CPU both backends take it, so the reports are equal."""
    cfg = CalibConfig(**{**_grid("paper-traces@0"),
                         "scenarios": PAPER_TRACES[:1]},
                      params=FleetParams(placement_backend="ref"))
    cell = f"{PAPER_TRACES[0]}@0"
    report = run_calibration(cfg, device="cpu")
    assert report["cells"] == {cell: calib_report["cells"][cell]}


def test_unknown_scenario_rejected():
    with pytest.raises(ValueError, match="paper trace"):
        run_calibration(CalibConfig(scenarios=("poisson_burst",),
                                    n_seeds=1, n_frames=4), device="cpu")


def test_no_device_means_cuda():
    cfg = CalibConfig(scenarios=("uniform",), n_seeds=1, n_frames=2)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA, so the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_calibration(cfg)
