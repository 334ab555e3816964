"""The port's observability layer against the JAX package's
(``repro_torch/obs`` vs ``repro/obs``):

- the fleet's in-loop telemetry: all 17 series of the port's
  ``TelemetryRecord`` are **bit-identical** to ``repro``'s on two
  scenarios, at ``telemetry_every`` 1 and 3 and ``segment_frames`` 0 and
  3, and ``capture_tick`` alone equals the reference's on seeded states;
- telemetry leaves the results alone: state and stats with it on and off
  are bit-identical to each other (also segmented and under
  ``REPRO_SANITIZE=1``) and to ``repro``'s;
- files and traces cross packages: an ``.npz`` saved by either loads in
  the other with equal arrays, ``to_jsonl`` gives equal text, the trace
  exporters give equal JSON that validates, and the CLI's ``record`` →
  ``export`` → ``summary`` gives the reference CLI's files and output;
- the rest of ``tests/test_obs.py`` against the port: delta series
  reconcile with the final counters, the strided grid, conservation on
  every paper trace, the phase timer and the segment spans; and the
  ``torch.profiler`` hook under ``REPRO_PROFILE_DIR``;
- ``repro_torch.obs`` loads neither ``jax`` nor ``repro``, and
  ``obs/export.py`` is pinned to its original.

Tolerance is exact equality throughout: the capture is compare, select,
min, max and f32 adds in the reference's order (see ``capture_tick``).
Both engines run the plain placement path; the JAX engine compiles once
per telemetry stride and segment length (four programs, plus the CLI's).
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as obs_j
import repro.obs.cli as cli_j
import repro.obs.export as export_j
import repro.obs.telemetry as telemetry_j
import repro_torch.obs as obs_t
import repro_torch.obs.cli as cli_t
import repro_torch.obs.export as export_t
import repro_torch.obs.telemetry as telemetry_t
from repro.fleet import FleetParams as FleetParams_j
from repro.fleet import fleet_run as fleet_run_j
from repro.fleet import make_fleet as make_fleet_j
from repro.fleet import make_workload, scenario_names
from repro.fleet.metrics import FleetStats as FleetStats_j
from repro.sim.engine import ExperimentConfig as ExperimentConfig_j
from repro.sim.engine import run_experiment as run_experiment_j
from repro_torch.analysis import sanitize
from repro_torch.carry import fleet_to_numpy, stats_to_numpy
from repro_torch.core.tensor_state import SchedState
from repro_torch.fleet import FleetParams, fleet_run, make_fleet, summarize
from repro_torch.fleet.metrics import (
    FleetStats, conservation_residual, per_replica_rates,
)
from repro_torch.kernels.placement import placement as placement_t
from repro_torch.obs import profile
from repro_torch.obs.events import EventLog
from repro_torch.obs.export import (
    fleet_trace_events, load_trace, sim_trace_events, validate_trace,
    write_chrome_trace,
)
from repro_torch.obs.telemetry import load_record
from repro_torch.sim.engine import ExperimentConfig, run_experiment

SRC = Path(__file__).resolve().parents[1] / "src"
B, F, DEV = 8, 8, 4
CASES = [("uniform", 0.0), ("weighted2", 0.3)]
EVERY = (1, 3)
SEGMENTS = (0, 3)


def _params(cls, **kw):
    return cls(n_devices=DEV, placement_backend="ref", **kw)


PARAMS = _params(FleetParams)
TPARAMS = _params(FleetParams, telemetry=True)


def _wl(scenario="weighted2", congestion=0.3, seed=0):
    return make_workload(scenario, B, F, DEV, seed=seed,
                         congestion=congestion)


def _run(params, wl=None):
    wl = wl or _wl()
    return fleet_run(make_fleet(B, DEV, device="cpu"), wl.values,
                     wl.bw_scale, params=params)


def _leaves(state, stats):
    """(name, numpy array) of every state leaf and counter."""
    fs = fleet_to_numpy(state) if isinstance(state.link_free,
                                             torch.Tensor) else state
    out = [(f"sched.{k}", np.asarray(v)) for k, v in
           zip(fs.sched._fields, fs.sched)]
    out += [(k, np.asarray(v)) for k, v in zip(fs._fields[1:], fs[1:])]
    st = stats_to_numpy(stats) if isinstance(stats.frames,
                                             torch.Tensor) else stats
    out += [(f"stats.{k}", np.asarray(v)) for k, v in
            zip(st._fields, st)]
    return out


def _assert_leaves_equal(a, b):
    for (name, x), (name_b, y) in zip(a, b, strict=True):
        assert name == name_b
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


def _assert_records_equal(rj, rt):
    """Every series bit for bit (dtype, shape, bytes), and the metadata."""
    assert np.array_equal(rj.ticks, rt.ticks)
    assert rj.ticks.dtype == rt.ticks.dtype
    assert (rj.n_frames, rj.every, rj.frame_period, rj.nominal_bw_bps) == (
        rt.n_frames, rt.every, rt.frame_period, rt.nominal_bw_bps)
    assert rj.series._fields == rt.series._fields
    for name in rj.series._fields:
        x, y = np.asarray(getattr(rj.series, name)), getattr(rt.series, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


@pytest.fixture(scope="module")
def jax_runs():
    """``repro``'s (state, stats, record) of every telemetry case, numpy."""
    out = {}
    for scen, cong in CASES:
        wl = _wl(scen, cong)
        for every in EVERY:
            for seg in SEGMENTS:
                p = _params(FleetParams_j, telemetry=True,
                            telemetry_every=every, segment_frames=seg)
                st, stats, rec = fleet_run_j(make_fleet_j(B, DEV), wl.values,
                                             wl.bw_scale, params=p)
                out[scen, every, seg] = (
                    jax.tree_util.tree_map(np.asarray, st),
                    jax.tree_util.tree_map(np.asarray, stats), rec)
    return out


# ---------------------------------------------------------------------------
# the series equal the reference's bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seg", SEGMENTS)
@pytest.mark.parametrize("every", EVERY)
@pytest.mark.parametrize("scen,cong", CASES)
def test_telemetry_series_match_reference(jax_runs, scen, cong, every, seg):
    _, _, rec_j = jax_runs[scen, every, seg]
    p = dataclasses.replace(TPARAMS, telemetry_every=every,
                            segment_frames=seg)
    _, _, rec = _run(p, _wl(scen, cong))
    assert rec.ticks.size == len(range(0, F, every))
    _assert_records_equal(rec_j, rec)


def test_telemetry_run_is_not_trivial(jax_runs):
    """The matched series move: HP runs and fails, LP places, windows
    free up and fill, the link backs up."""
    s = jax_runs["weighted2", 1, 0][2].series
    for name in ("hp_run_dev", "hp_fail_dev", "lp_placed_dev",
                 "free_windows", "lp_completed_d"):
        assert getattr(s, name).sum() > 0, name
    assert np.unique(s.free_time).size > 10
    assert (s.link_free > 0).any()


def _seeded_state(seed, batch=16):
    """A seeded batch of windows, counters and link heads, as numpy."""
    rng = np.random.default_rng(seed)
    shape = (batch, DEV, 3, 2, 16)
    t1 = rng.uniform(0.0, 60.0, shape).astype(np.float32)
    t2 = (t1 + rng.uniform(-2.0, 40.0, shape)).astype(np.float32)
    valid = rng.random(shape) < 0.6

    def counters():
        return {f: rng.integers(0, 50, batch).astype(np.int32)
                if f not in ("start_delay_sum", "comm_busy")
                else rng.uniform(0, 9, batch).astype(np.float32)
                for f in FleetStats._fields}

    prev = counters()
    now = {k: (v + rng.integers(0, 3, batch).astype(v.dtype))
           for k, v in prev.items()}
    return dict(
        t1=t1, t2=t2, valid=valid, prev=prev, now=now,
        link_free=rng.uniform(0, 80, batch).astype(np.float32),
        rq_valid=rng.random((batch, 4)) < 0.3,
        bw=rng.uniform(0.05, 1.5, batch).astype(np.float32),
        counts=[rng.random((batch, DEV)) < 0.4 for _ in range(3)]
        + [rng.integers(0, 5, (batch, DEV)).astype(np.int32)],
    )


@pytest.mark.parametrize("f", [0, 1, 7, 94])
def test_capture_tick_matches_reference(f):
    """``capture_tick`` alone, on the same seeded state, against the
    reference's jitted ``capture_tick``: every series bit for bit."""
    x = _seeded_state(seed=f)

    @jax.jit
    def ref(t1, t2, valid, link_free, rq_valid, prev, now, bw, counts, f):
        base = f.astype(jnp.float32) * telemetry_j.FRAME_PERIOD
        st = SimpleNamespace(win_t1=t1, win_t2=t2, win_valid=valid)
        return telemetry_j.capture_tick(
            st, link_free, rq_valid, prev, now, base, bw, 20e6,
            *(c.astype(jnp.int32) for c in counts))

    got_j = ref(x["t1"], x["t2"], x["valid"], x["link_free"],
                x["rq_valid"], FleetStats_j(**x["prev"]),
                FleetStats_j(**x["now"]), x["bw"], x["counts"],
                jnp.int32(f))
    t = torch.as_tensor
    base = torch.tensor(f, dtype=torch.float32) * telemetry_t.FRAME_PERIOD
    got_t = telemetry_t.capture_tick(
        SimpleNamespace(win_t1=t(x["t1"]), win_t2=t(x["t2"]),
                        win_valid=t(x["valid"])),
        t(x["link_free"]), t(x["rq_valid"]),
        FleetStats(**{k: t(v) for k, v in x["prev"].items()}),
        FleetStats(**{k: t(v) for k, v in x["now"].items()}),
        base, t(x["bw"]), 20e6, *(t(c) for c in x["counts"]))
    for name, a, b in zip(telemetry_j.TelemetryFrame._fields, got_j, got_t):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


# ---------------------------------------------------------------------------
# bit-identity: telemetry capture must not perturb the simulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scen,cong", CASES)
def test_telemetry_leaves_results_alone(jax_runs, scen, cong):
    """On and off give the same state and stats, and so does ``repro``
    (whose own tests pin its on and off runs to each other)."""
    wl = _wl(scen, cong)
    off = _leaves(*_run(PARAMS, wl))
    state, stats, rec = _run(TPARAMS, wl)
    _assert_leaves_equal(off, _leaves(state, stats))
    st_j, stats_j, _ = jax_runs[scen, 1, 0]
    _assert_leaves_equal(_leaves(st_j, stats_j), off)
    assert rec.ticks.size == F and rec.n_replicas == B


def test_telemetry_bit_identical_under_segmenting():
    seg_off = dataclasses.replace(PARAMS, segment_frames=3)
    seg_on = dataclasses.replace(TPARAMS, segment_frames=3)
    off = _leaves(*_run(seg_off))
    state, stats, rec = _run(seg_on)
    _assert_leaves_equal(off, _leaves(state, stats))
    assert rec.ticks.size == F
    _assert_leaves_equal(off, _leaves(*_run(PARAMS)))


def test_telemetry_bit_identical_under_sanitize(monkeypatch):
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    off = _leaves(*_run(PARAMS))
    state, stats, _ = _run(TPARAMS)
    _assert_leaves_equal(off, _leaves(state, stats))


def test_kernel_is_not_launched_on_cpu():
    _run(TPARAMS)
    assert placement_t.launches == 0


# ---------------------------------------------------------------------------
# series content: per-tick deltas reconcile with the final counters
# ---------------------------------------------------------------------------

def test_delta_series_reconcile_with_final_counters():
    _, stats, rec = _run(TPARAMS)
    s = rec.series
    stats = stats_to_numpy(stats)
    for series, field in (
        (s.hp_completed_d, "hp_completed"),
        (s.hp_failed_d, "hp_failed"),
        (s.hp_preempted_d, "hp_preempted"),
        (s.lp_spawned_d, "lp_spawned"),
        (s.lp_completed_d, "lp_completed"),
        (s.lp_failed_d, "lp_failed"),
        (s.lp_requeued_d, "lp_requeued"),
        (s.missed_by_preemption_d, "missed_by_preemption"),
    ):
        np.testing.assert_array_equal(
            series.sum(axis=0), getattr(stats, field), err_msg=field)
    # per-device series reduce to the same per-replica counters
    np.testing.assert_array_equal(s.preempt_dev.sum(axis=(0, 2)),
                                  stats.hp_preempted)
    np.testing.assert_array_equal(s.hp_fail_dev.sum(axis=(0, 2)),
                                  stats.hp_failed)
    assert s.rq_depth.min() >= 0 and s.bandwidth_bps.min() > 0


def test_strided_capture_samples_the_full_grid():
    every = 3
    state_full, stats_full, full = _run(TPARAMS)
    p = dataclasses.replace(TPARAMS, telemetry_every=every,
                            segment_frames=5)
    state_strided, stats_strided, strided = _run(p)
    # striding must not perturb the simulation either
    _assert_leaves_equal(_leaves(state_full, stats_full),
                         _leaves(state_strided, stats_strided))
    np.testing.assert_array_equal(strided.ticks,
                                  np.arange(0, F, every, dtype=np.int64))
    # strided rows are exact samples of the full-capture series
    for name in full.series._fields:
        np.testing.assert_array_equal(
            getattr(strided.series, name),
            getattr(full.series, name)[strided.ticks], err_msg=name)


def test_record_save_load_roundtrip(tmp_path):
    _, _, rec = _run(TPARAMS)
    path = str(tmp_path / "rec.npz")
    rec.save(path)
    back = load_record(path)
    assert back.every == rec.every and back.n_frames == rec.n_frames
    assert back.nominal_bw_bps == rec.nominal_bw_bps
    for name in rec.series._fields:
        np.testing.assert_array_equal(getattr(back.series, name),
                                      getattr(rec.series, name))


# ---------------------------------------------------------------------------
# files and traces across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [
    (telemetry_t, telemetry_j), (telemetry_j, telemetry_t),
], ids=["port-to-reference", "reference-to-port"])
def test_npz_loads_across_packages(jax_runs, tmp_path, writer, reader):
    """A recording saved by one package loads in the other unchanged."""
    rec_j = jax_runs["weighted2", 3, 3][2]
    rec = writer.TelemetryRecord(*rec_j)
    path = str(tmp_path / "rec.npz")
    rec.save(path)
    _assert_records_equal(rec_j, reader.load_record(path))


def test_to_jsonl_text_equal(jax_runs, tmp_path):
    rec_j = jax_runs["weighted2", 1, 0][2]
    _, _, rec = _run(TPARAMS)
    for replica in (0, B - 1):
        pj, pt = tmp_path / f"j{replica}.jsonl", tmp_path / f"t{replica}.jsonl"
        rec_j.to_jsonl(str(pj), replica=replica)
        rec.to_jsonl(str(pt), replica=replica)
        assert pj.read_text() == pt.read_text() and pj.read_text()


def test_fleet_trace_events_equal_across_packages(jax_runs):
    rec_j = jax_runs["weighted2", 1, 0][2]
    _, _, rec = _run(TPARAMS)
    for reps in (None, [0, B - 1]):
        ev_j = export_j.fleet_trace_events(rec_j, replicas=reps)
        ev_t = fleet_trace_events(rec, replicas=reps)
        assert json.dumps(ev_t) == json.dumps(ev_j)
        assert validate_trace({"traceEvents": ev_t}) == []


def test_sim_trace_events_equal_across_packages():
    kw = dict(trace="weighted2", n_frames=F, seed=0, duty_cycle=0.3)
    log_j, log_t = obs_j.EventLog(), EventLog()
    run_experiment_j(ExperimentConfig_j(**kw), event_log=log_j)
    run_experiment(ExperimentConfig(**kw), event_log=log_t)
    ev_j, ev_t = export_j.sim_trace_events(log_j), sim_trace_events(log_t)
    assert ev_t and json.dumps(ev_t) == json.dumps(ev_j)
    assert validate_trace({"traceEvents": ev_t}) == []


def test_export_copy_matches_its_original():
    assert (inspect.getsource(export_t).replace("repro_torch", "repro")
            == inspect.getsource(export_j))


def test_obs_exports_match_reference():
    assert obs_t.__all__ == [
        "maybe_torch_trace" if n == "maybe_jax_trace" else n
        for n in obs_j.__all__]
    assert telemetry_t.TelemetryFrame._fields == \
        telemetry_j.TelemetryFrame._fields
    assert telemetry_t.TelemetryRecord._fields == \
        telemetry_j.TelemetryRecord._fields


# ---------------------------------------------------------------------------
# conservation identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", scenario_names())
def test_conservation_residual_zero_on_paper_traces(scenario):
    for congestion in (0.0, 0.3):
        state, stats = _run(PARAMS, _wl(scenario, congestion))
        residual = conservation_residual(stats, state.rq_valid.sum(1))
        np.testing.assert_array_equal(
            residual, 0, err_msg=f"{scenario}@{congestion}")


def test_summarize_reports_rq_depth_and_residual():
    state, stats = _run(PARAMS)
    pending = state.rq_valid.sum(1).numpy()
    rates = per_replica_rates(stats, rq_pending=pending)
    np.testing.assert_array_equal(rates["rq_pending_depth"], pending)
    out = summarize(stats, F, rq_pending=pending)
    assert out["conservation_residual"]["max_abs"] == 0
    assert "rq_pending_depth" in out
    legacy = summarize(stats, F)
    assert "conservation_residual" not in legacy
    assert "rq_pending_depth" not in legacy


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def test_fleet_trace_export_valid(tmp_path):
    _, _, rec = _run(TPARAMS)
    events = fleet_trace_events(rec, replicas=[0, 1])
    path = str(tmp_path / "fleet.trace.json")
    write_chrome_trace(path, events)
    obj = load_trace(path)
    assert validate_trace(obj) == []
    names = {e["name"] for e in obj["traceEvents"]}
    assert "rq_depth" in names and "bandwidth_mbps" in names
    meta = [e for e in obj["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"]
    assert len({(e["pid"], e["tid"]) for e in meta}) >= 2 * DEV


def test_validate_trace_rejects_malformed():
    assert validate_trace({"traceEvents": "nope"})
    assert validate_trace({"traceEvents": [{"ph": "Z", "name": "x",
                                            "pid": 0, "tid": 0, "ts": 0}]})
    assert validate_trace({"traceEvents": [
        {"ph": "X", "name": "x", "pid": 0, "tid": 0, "ts": 0, "dur": -1}
    ]})


# ---------------------------------------------------------------------------
# the CLI against the reference's
# ---------------------------------------------------------------------------

def _cli_session(main, out, engine, capsys):
    """record -> export -> summary of the recording and of its trace;
    the printed text (paths cut) and every file written."""
    args = ["record", "--engine", engine, "--scenario", "weighted2",
            "--frames", str(F), "--congestion", "0.3", "--out", out]
    if engine == "fleet":
        args += ["--batch", str(B)]
        if main is cli_t.main:
            args += ["--device", "cpu"]
    assert main(args) == 0
    rec = next(os.path.join(out, n) for n in sorted(os.listdir(out))
               if n.endswith((".npz", ".jsonl")))
    assert main(["export", "--input", rec]) == 0
    trace = os.path.splitext(rec)[0] + ".trace.json"
    assert validate_trace(load_trace(trace)) == []
    assert main(["summary", "--input", rec]) == 0
    assert main(["summary", "--input", trace]) == 0
    text = capsys.readouterr().out.replace(out, "<out>")
    return text, {n: Path(out, n).read_bytes()
                  for n in sorted(os.listdir(out))}


@pytest.mark.parametrize("engine", ["fleet", "serial"])
def test_cli_matches_reference(tmp_path, capsys, engine):
    text_j, files_j = _cli_session(cli_j.main, str(tmp_path / "j"), engine,
                                   capsys)
    text_t, files_t = _cli_session(cli_t.main, str(tmp_path / "t"), engine,
                                   capsys)
    assert text_t == text_j and "-> <out>" in text_t
    assert sorted(files_t) == sorted(files_j)
    for name in files_j:
        if name.endswith(".npz"):
            _assert_records_equal(
                telemetry_j.load_record(str(tmp_path / "j" / name)),
                load_record(str(tmp_path / "t" / name)))
        else:
            assert files_t[name] == files_j[name], name


def test_cli_record_device_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_t.main(["record", "--frames", "2", "--out", str(tmp_path)])


# ---------------------------------------------------------------------------
# host-side phase profiling and the torch.profiler hook
# ---------------------------------------------------------------------------

def test_phase_timer_spans_and_save(tmp_path):
    with profile.span("obs/inactive"):
        pass  # no active timer: must be a silent no-op
    t = profile.PhaseTimer()
    with t:
        with profile.span("obs/a"):
            pass
        with profile.span("obs/a"):
            with profile.span("obs/b"):
                pass
    with profile.span("obs/after"):
        pass  # timer exited: not recorded
    s = t.summary()
    assert s["obs/a"]["count"] == 2 and s["obs/b"]["count"] == 1
    assert "obs/after" not in s and "obs/inactive" not in s
    path = str(tmp_path / "profile.json")
    payload = t.save(path, extra={"note": 1})
    assert json.load(open(path)) == payload and payload["note"] == 1


#: spans of a B x F run on DEV devices: a tick, and in each tick the
#: re-queue pass and each device's victim re-placement, HP and LP phases,
#: and a compaction every 8th tick
SPAN_COUNTS = {"fleet/tick": F, "fleet/requeue": F * (1 + DEV),
               "fleet/hp": F * DEV, "fleet/lp": F * DEV,
               "fleet/compaction": F // 8}


@pytest.mark.parametrize("seg,segments", [(0, 1), (3, 3), (5, 2)])
def test_fleet_run_records_segment_spans(seg, segments):
    want = {"fleet/segment": segments, **SPAN_COUNTS}
    for params in (PARAMS, TPARAMS):
        with profile.PhaseTimer() as t:
            _run(dataclasses.replace(params, segment_frames=seg))
        assert {k: v["count"] for k, v in t.summary().items()} == want


def test_span_records_carry_name_parent_trace_and_times():
    with profile.PhaseTimer() as t:
        with profile.span("obs/a", trace=(7, 3), device="cpu"):
            with profile.span("obs/b"):
                pass
        with profile.span("obs/c"):
            pass
    r = t.records()
    assert [x["name"] for x in r] == ["obs/a", "obs/b", "obs/c"]
    assert [x["parent"] for x in r] == [None, 0, None]
    assert [x["trace"] for x in r] == [[7, 3], [7, 3], None]
    assert [x["device"] for x in r] == ["cpu", "cpu", None]
    assert all(x["device_ms"] is None for x in r)
    assert all(x["start_ns"] <= x["end_ns"] for x in r)
    assert r[0]["start_ns"] <= r[1]["start_ns"] <= r[1]["end_ns"] \
        <= r[0]["end_ns"] <= r[2]["start_ns"]


def test_fleet_run_spans_form_one_tree_a_tick():
    """Every span inside a tick carries the tick's ``(run, f)`` and lies
    inside its parent; two runs get two run identifiers."""
    with profile.PhaseTimer() as t:
        _run(PARAMS)
        _run(PARAMS)
    recs = t.records()
    ticks = [r for r in recs if r["name"] == "fleet/tick"]
    runs = sorted({r["trace"][0] for r in ticks})
    assert len(runs) == 2
    assert sorted(tuple(r["trace"]) for r in ticks) == sorted(
        (run, f) for run in runs for f in range(F))
    for r in recs:
        if r["parent"] is None:
            assert r["name"] == "fleet/segment" and r["trace"] is None
            continue
        up = recs[r["parent"]]
        assert up["start_ns"] <= r["start_ns"] <= r["end_ns"] <= up["end_ns"]
        if r["name"] == "fleet/tick":
            assert up["name"] == "fleet/segment"
        else:
            assert up["name"] == "fleet/tick"
            assert r["trace"] == up["trace"] and r["device"] == "cpu"


def test_self_time_is_span_less_children():
    with profile.PhaseTimer() as t:
        with profile.span("obs/a"):
            with profile.span("obs/b"):
                sum(range(20000))
            sum(range(20000))
            with profile.span("obs/b"):
                sum(range(20000))
    ph = t.phases()
    r = t.records()
    host = [(x["end_ns"] - x["start_ns"]) / 1e6 for x in r]
    assert ph["obs/a"]["count"] == 1 and ph["obs/b"]["count"] == 2
    assert ph["obs/a"]["host_ms"] == pytest.approx(host[0], abs=1e-9)
    assert ph["obs/a"]["self_host_ms"] == pytest.approx(
        host[0] - host[1] - host[2], abs=1e-9)
    assert ph["obs/b"]["self_host_ms"] == pytest.approx(
        ph["obs/b"]["host_ms"], abs=1e-9)
    assert 0 < ph["obs/a"]["self_host_ms"] < ph["obs/a"]["host_ms"]
    assert ph["obs/a"]["device_ms"] is None


def test_spans_are_host_ops_of_a_profiler_session():
    """Inside a ``torch.profiler`` session each span is a host ``cpu_op``
    of its name, on the records' clock within 50 us, and never a user
    annotation (which would give the card an event of its name)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        with profile.PhaseTimer() as t:
            _run_short(PARAMS)
    recs = t.records()
    names = {r["name"] for r in recs}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in names]
    assert not [e for e in events if e.is_user_annotation()]
    assert len(events) == len(recs)
    for name in names:
        got = sorted((e.start_ns(), e.end_ns()) for e in events
                     if e.name() == name)
        want = sorted((r["start_ns"], r["end_ns"]) for r in recs
                      if r["name"] == name)
        for (a, b), (c, d) in zip(got, want, strict=True):
            assert abs(a - c) <= 50_000 and abs(b - d) <= 50_000, name
    assert all(e.activity_type() == "cpu_op" for e in events)


@pytest.mark.parametrize("mode", ["plain", "telemetry", "sanitize"])
def test_fleet_run_bit_identical_under_every_timer(mode, monkeypatch):
    """No timer, a host timer and a device-timed timer (which also counts
    the placement attempts) give the same leaves, and the same telemetry
    record."""
    if mode == "sanitize":
        monkeypatch.setenv(sanitize.ENV_VAR, "1")
    params = TPARAMS if mode == "telemetry" else PARAMS
    want = _run(params)
    for timer in (profile.PhaseTimer(),
                  profile.PhaseTimer(device_time=True)):
        with timer:
            got = _run(params)
        _assert_leaves_equal(_leaves(*want[:2]), _leaves(*got[:2]))
        if mode == "telemetry":
            _assert_records_equal(want[2], got[2])
        assert bool(timer.counters()) == timer.device_time


def test_counters_only_under_a_device_timed_timer():
    assert profile.counter("obs/n", (2,), "cpu") is None
    with profile.PhaseTimer() as host:
        assert profile.counter("obs/n", (2,), "cpu") is None
        with profile.PhaseTimer(device_time=True) as timed:
            buf = profile.counter("obs/n", (2,), "cpu")
            buf += torch.tensor([3, 1])
            profile.counter("obs/n", (2,), "cpu").add_(1)
    assert host.counters() == {}
    assert timed.counters() == {"obs/n": [4, 2]}


def test_save_writes_spans_and_counters(tmp_path):
    with profile.PhaseTimer(device_time=True) as t:
        _run(PARAMS)
    path = str(tmp_path / "spans.json")
    payload = t.save(path)
    assert json.load(open(path)) == payload
    assert len(payload["spans"]) == sum(SPAN_COUNTS.values()) + 1
    counts = payload["counters"]["fleet/fused_place"]
    assert len(counts) == 1 + DEV * 5
    assert all(0 <= ok <= do for do, ok in counts)


def _traces(path):
    return sorted(p.name for p in Path(path).glob("*.pt.trace.json"))


def _run_short(params):
    """A 2-tick run (the profiler records every op of it)."""
    wl = _wl()
    return fleet_run(make_fleet(B, DEV, device="cpu"), wl.values[:2],
                     wl.bw_scale[:2], params=params)


def test_profile_dir_writes_a_torch_trace(tmp_path, monkeypatch):
    """With ``REPRO_PROFILE_DIR`` set, ``fleet_run`` writes one Chrome
    trace of its loop there, naming the engine's ops; nested blocks
    trace once; unset, nothing is written."""
    monkeypatch.delenv(profile.ENV_VAR, raising=False)
    want = _leaves(*_run_short(PARAMS))
    monkeypatch.setenv(profile.ENV_VAR, str(tmp_path))
    with profile.maybe_torch_trace():
        got = _leaves(*_run_short(PARAMS))
    files = _traces(tmp_path)
    assert len(files) == 1
    obj = load_trace(str(tmp_path / files[0]))
    names = {e.get("name") for e in obj["traceEvents"]}
    assert "aten::minimum" in names and "aten::where" in names
    _assert_leaves_equal(want, got)
    _run_short(PARAMS)
    assert len(_traces(tmp_path)) == 2


def test_profile_dir_trace_shows_the_ticks_and_their_phases(
        tmp_path, monkeypatch):
    """Under a timer, the trace ``REPRO_PROFILE_DIR`` writes holds every
    span as a host op of its name, so the timeline shows each tick and
    its phases."""
    monkeypatch.setenv(profile.ENV_VAR, str(tmp_path))
    with profile.PhaseTimer() as t:
        _run_short(PARAMS)
    obj = load_trace(str(tmp_path / _traces(tmp_path)[0]))
    got = [(e["name"], e.get("cat")) for e in obj["traceEvents"]
           if e.get("name", "").startswith("fleet/")]
    assert sorted(n for n, _ in got) == sorted(
        r["name"] for r in t.records())
    assert {c for _, c in got} == {"cpu_op"}


def test_profile_hook_passes_through_another_profiler(tmp_path,
                                                      monkeypatch):
    """Inside a caller's own ``torch.profiler`` session the hook does
    nothing (a second session would raise), and the caller's trace sees
    the engine's ops."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    monkeypatch.setenv(profile.ENV_VAR, str(tmp_path))
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_short(PARAMS)
    assert _traces(tmp_path) == []
    assert any(e.key == "aten::minimum" for e in prof.key_averages())


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", [
    "repro_torch.obs", "repro_torch.obs.cli", "repro_torch.fleet",
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


def test_capture_is_read_only():
    """``capture_tick`` writes nothing into the state it reads."""
    x = _seeded_state(seed=5)
    t = torch.as_tensor
    st = SchedState(t(x["t1"]), t(x["t2"]), t(x["valid"]),
                    *(torch.zeros(1) for _ in SchedState._fields[3:]))
    before = [v.clone() for v in st[:3]]
    stats = FleetStats(**{k: t(v) for k, v in x["now"].items()})
    telemetry_t.capture_tick(
        st, t(x["link_free"]), t(x["rq_valid"]), stats, stats,
        torch.tensor(3 * telemetry_t.FRAME_PERIOD, dtype=torch.float32),
        t(x["bw"]), 20e6, *(t(c) for c in x["counts"]))
    for a, b in zip(before, st[:3]):
        assert torch.equal(a, b)
