"""The port's serial discrete-event simulator against the JAX package.

The DES (``sim/engine.py``), its congestion model and metrics, the HYB
scheduler (``core/hybrid.py``) and the event log (``obs/events.py``) are
framework-neutral copies, pinned byte for byte to their originals (after
``repro_torch`` -> ``repro``). ``run_experiment`` of both packages then
gives equal ``Metrics`` and equal event logs, field by field, for RAS, WPS
and HYB on every paper trace with and without §VI.C congestion: the same
Python runs on the same numpy generator, so equality is exact. The
behavioural cases of ``tests/test_sim.py`` are repeated against the port.

Each run starts from a fresh ``ExperimentConfig``: both packages keep their
own global task-id counter, reset by every ``Simulation``.
"""

import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.core.hybrid as hybrid_j
import repro.obs.events as events_j
import repro.sim.congestion as congestion_j
import repro.sim.engine as engine_j
import repro.sim.metrics as metrics_j
import repro_torch.core.hybrid as hybrid_t
import repro_torch.obs.events as events_t
import repro_torch.sim.congestion as congestion_t
import repro_torch.sim.engine as engine_t
import repro_torch.sim.metrics as metrics_t
from repro_torch.obs import EventLog
from repro_torch.sim.congestion import CongestionModel, LinkActivity
from repro_torch.sim.engine import ExperimentConfig, run_experiment
from repro_torch.sim.traces import generate_trace

SRC = Path(__file__).resolve().parents[1] / "src"
PAPER_TRACES = ("uniform", "weighted1", "weighted2", "weighted3", "weighted4")
N_FRAMES = 95


# ---------------------------------------------------------------------------
# the copies are pinned
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module_pair", [
    (events_t, events_j), (congestion_t, congestion_j),
    (metrics_t, metrics_j), (hybrid_t, hybrid_j), (engine_t, engine_j),
], ids=["obs.events", "sim.congestion", "sim.metrics", "core.hybrid",
        "sim.engine"])
def test_copied_module_matches_its_original(module_pair):
    port, orig = module_pair
    assert (inspect.getsource(port).replace("repro_torch", "repro")
            == inspect.getsource(orig))


def test_obs_package_exports_only_the_event_log():
    import repro_torch.obs as obs_t

    assert obs_t.__all__ == ["Event", "EventLog", "KINDS"]
    assert obs_t.KINDS == events_j.KINDS


@pytest.mark.parametrize("module", [
    "repro_torch.sim.engine", "repro_torch.calib",
    "repro_torch.analysis.sanitize",
])
def test_import_loads_no_jax_and_no_repro(module):
    code = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({module!r})
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120,
    )
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# run_experiment: equal Metrics and equal event logs
# ---------------------------------------------------------------------------

def _run_both(**kw):
    """The same experiment through both packages, each from a fresh config
    and with its own event log."""
    log_j, log_t = engine_j.EventLog(), EventLog()
    m_j = engine_j.run_experiment(engine_j.ExperimentConfig(**kw),
                                  event_log=log_j)
    m_t = run_experiment(ExperimentConfig(**kw), event_log=log_t)
    return (m_j, log_j), (m_t, log_t)


def _assert_equal_runs(ref, got):
    (m_j, log_j), (m_t, log_t) = ref, got
    assert dataclasses.asdict(m_t) == dataclasses.asdict(m_j)
    assert m_t.calib_view() == m_j.calib_view()
    assert m_t.summary() == m_j.summary()
    assert len(log_t) == len(log_j) > 0
    for i, (e_t, e_j) in enumerate(zip(log_t, log_j)):
        assert dataclasses.asdict(e_t) == dataclasses.asdict(e_j), i


@pytest.mark.parametrize("duty", [0.0, 0.3])
@pytest.mark.parametrize("trace", PAPER_TRACES)
@pytest.mark.parametrize("sched", ["ras", "wps", "hyb"])
def test_run_experiment_matches_reference(sched, trace, duty):
    ref, got = _run_both(scheduler=sched, trace=trace, n_frames=N_FRAMES,
                         duty_cycle=duty, seed=3)
    _assert_equal_runs(ref, got)


def test_run_experiment_matches_reference_adaptive_probing():
    ref, got = _run_both(scheduler="ras", trace="weighted4",
                         n_frames=N_FRAMES, duty_cycle=0.5, bw_interval=10.0,
                         bw_adaptive=True, seed=7)
    _assert_equal_runs(ref, got)
    assert got[0].bw_updates > 0


def test_hyb_is_picked_by_the_config():
    sched = ExperimentConfig(scheduler="hyb").make_scheduler()
    assert isinstance(sched, hybrid_t.HybridScheduler)


def test_event_log_jsonl_roundtrip(tmp_path):
    log = EventLog()
    run_experiment(ExperimentConfig(trace="weighted2", n_frames=10, seed=1),
                   event_log=log)
    path = str(tmp_path / "events.jsonl")
    log.to_jsonl(path)
    back = EventLog.from_jsonl(path)
    assert [dataclasses.asdict(e) for e in back] == [
        dataclasses.asdict(e) for e in log]
    assert set(log.counts()) <= set(events_t.KINDS)


# ---------------------------------------------------------------------------
# the behavioural cases of tests/test_sim.py, on the port
# ---------------------------------------------------------------------------

class TestTraces:
    def test_shapes_and_values(self):
        tr = generate_trace("uniform", 50, 4, seed=1)
        assert tr.entries.shape == (50, 4)
        assert set(tr.entries.flatten()).issubset({-1, 0, 1, 2, 3, 4})

    def test_weighted_dominates(self):
        flat = generate_trace("weighted3", 400, 4, seed=1).entries.flatten()
        counts = {v: (flat == v).sum() for v in (1, 2, 3, 4)}
        assert counts[3] > 2 * max(counts[1], counts[2], counts[4])

    def test_deterministic(self):
        a = generate_trace("weighted2", 30, 4, seed=9)
        b = generate_trace("weighted2", 30, 4, seed=9)
        assert (a.entries == b.entries).all()

    def test_load_increases_with_weight(self):
        loads = [
            generate_trace(f"weighted{x}", 200, 4, seed=0).total_lp_tasks()
            for x in (1, 2, 3, 4)
        ]
        assert loads == sorted(loads)


class TestCongestion:
    def test_duty_cycle_burst_windows(self):
        m = CongestionModel(20e6, duty_cycle=0.5, period=30.0, intensity=0.6,
                            walk_sigma=0.0)
        assert m.in_burst(1.0) and not m.in_burst(16.0)
        assert m.bw(1.0) == pytest.approx(8e6)
        assert m.bw(16.0) == pytest.approx(20e6)

    def test_transfer_end_integrates_bursts(self):
        m = CongestionModel(10e6, duty_cycle=0.5, period=10.0, intensity=0.5,
                            walk_sigma=0.0)
        # 5 Mbit at 5 Mbps burst bandwidth: crosses the burst edge at t=5
        end = m.transfer_end(0.0, 5e6 / 8 * 1.2)
        assert end == m.transfer_end(0.0, 5e6 / 8 * 1.2)  # deterministic
        no_burst = CongestionModel(10e6, walk_sigma=0.0).transfer_end(
            0.0, 5e6 / 8)
        assert end > no_burst

    def test_busy_fraction(self):
        la = LinkActivity()
        la.add(0.0, 5.0)
        assert la.busy_fraction(0.0, 10.0) == pytest.approx(0.5)
        la.prune(6.0)
        assert la.busy_fraction(0.0, 10.0) == 0.0


class TestEngine:
    def test_deterministic(self):
        cfg = ExperimentConfig(trace="weighted2", n_frames=20, seed=11)
        assert run_experiment(cfg).summary() == run_experiment(cfg).summary()

    def test_zero_noise_no_violations_ras(self):
        m = run_experiment(ExperimentConfig(
            scheduler="ras", trace="weighted2", n_frames=30, seed=3,
            proc_jitter=0.0, bw_walk_sigma=0.0,
        ))
        assert m.lp_violated == 0
        assert m.hp_violated == 0

    def test_frame_accounting(self):
        m = run_experiment(ExperimentConfig(trace="weighted1", n_frames=25,
                                            seed=5))
        assert 0 < m.frames_total <= 25 * 4
        assert 0 <= m.frames_completed <= m.frames_total
        assert (m.lp_completed + m.lp_violated
                <= m.lp_spawned + m.lp_realloc_success)

    @pytest.mark.parametrize("sched", ["ras", "wps", "hyb"])
    def test_controller_serialisation(self, sched):
        m = run_experiment(ExperimentConfig(scheduler=sched, trace="weighted4",
                                            n_frames=25, seed=2))
        assert m.controller_busy_time > 0.0

    @staticmethod
    def _base_and_congested():
        return (run_experiment(ExperimentConfig(
            trace="weighted4", n_frames=40, seed=4, duty_cycle=d))
            for d in (0.0, 0.75))

    def test_congestion_hurts_completion(self):
        base, congested = self._base_and_congested()
        assert congested.frame_completion_rate < base.frame_completion_rate

    def test_congestion_shifts_to_four_core(self):
        base, congested = self._base_and_congested()
        assert congested.four_core_fraction >= base.four_core_fraction

    def test_paper_headline_crossover(self):
        """§VI.A: WPS competitive under the lightest load (within seed
        noise); RAS wins under W4."""
        def fc(sched, trace):
            return run_experiment(ExperimentConfig(
                scheduler=sched, trace=trace, n_frames=60, seed=7,
            )).frame_completion_rate

        assert fc("wps", "weighted1") >= fc("ras", "weighted1") - 0.02
        assert fc("ras", "weighted4") > fc("wps", "weighted4")

    def test_latency_ordering_matches_paper(self):
        ras, wps = (run_experiment(ExperimentConfig(
            scheduler=s, trace="weighted3", n_frames=40, seed=7))
            for s in ("ras", "wps"))
        assert ras.lp_alloc_latency.mean < wps.lp_alloc_latency.mean / 10
        assert ras.hp_preempt_latency.mean < wps.hp_preempt_latency.mean


def test_adaptive_probing_beats_fixed_under_congestion():
    """Beyond-paper (§VII future work): volatility-driven probe intervals
    outperform the best fixed interval under bursty congestion."""
    def fc(**kw):
        vals = [run_experiment(ExperimentConfig(
            scheduler="ras", trace="weighted4", n_frames=60, seed=s,
            duty_cycle=0.5, **kw)).frame_completion_rate for s in (7, 11)]
        return sum(vals) / len(vals)

    assert fc(bw_interval=10.0, bw_adaptive=True) > fc(bw_interval=30.0)


def test_fleet_scaling_favours_ras():
    """Beyond-paper: WPS query latency grows super-linearly with fleet
    size while RAS stays near-flat."""
    def lat(sched, n):
        return run_experiment(ExperimentConfig(
            scheduler=sched, trace="weighted4", n_frames=30, n_devices=n,
            seed=7)).lp_alloc_latency.mean

    assert lat("wps", 16) > 3 * lat("wps", 4)      # super-linear growth
    assert lat("ras", 16) < 3 * lat("ras", 4)      # near-linear, tiny constant
    assert lat("ras", 16) * 10 < lat("wps", 16)
