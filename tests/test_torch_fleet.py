"""The port's fleet engine against the JAX package: the same workload
through ``repro`` ``fleet_run`` and the port's ``fleet_run`` gives the
same counters and the same final state, on every registered scenario,
with the re-queue buffer on (R=4) and off (R=0), at a batch that is not a
multiple of 8 and over enough frames to cross ``compact_every`` twice.
Also: a run started from a mid-run ``repro`` state carried across,
the unsharded sweep summary, the conservation residual, and the device
rules of the entry points.

Tolerance is exact equality: the engine is f32 compare, min, max, select
and add (see the port's ``fleet/engine.py`` for the three rules that make
its rounding the reference's), so 0 ULP is reachable.

Both engines use the plain placement path, and every JAX call shares one
shape signature per R, so the file compiles the reference twice.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.fleet import FleetParams as FleetParams_j
from repro.fleet import SweepConfig as SweepConfig_j
from repro.fleet import fleet_run as fleet_run_j
from repro.fleet import make_fleet as make_fleet_j
from repro.fleet import make_workload, run_sweep as run_sweep_j
from repro.fleet import scenario_names
from repro_torch.carry import fleet_from_numpy, fleet_to_numpy
from repro_torch.carry import stats_to_numpy
from repro_torch.fleet import FleetParams, SweepConfig, fleet_run
from repro_torch.fleet import make_fleet, run_sweep
from repro_torch.fleet.metrics import conservation_residual
from repro_torch.kernels.placement import placement as placement_t
from repro_torch.obs import profile

PER_SCENARIO = 2
SCENARIOS = scenario_names()
B = PER_SCENARIO * len(SCENARIOS) + 1      # 17: not a multiple of 8
F = 20                                     # crosses compact_every=8 twice
SEG = 8                                    # one JAX segment shape for all F


def _params(cls, R):
    return cls(placement_backend="ref", segment_frames=SEG, requeue_slots=R)


def _population(n_frames, seed):
    """``PER_SCENARIO`` replicas of every scenario (congestion alternating
    0 / 0.3), plus one more of the first."""
    vals, bws = [], []
    for i, scen in enumerate(SCENARIOS):
        n = PER_SCENARIO + (i == 0)
        wl = make_workload(scen, n, n_frames, seed=seed + i,
                           congestion=0.3 * (i % 2))
        vals.append(wl.values)
        bws.append(wl.bw_scale)
    return np.concatenate(vals, axis=1), np.concatenate(bws, axis=1)


def _columns(scen):
    i = SCENARIOS.index(scen)
    start = i * PER_SCENARIO + (i > 0)
    return slice(start, start + PER_SCENARIO + (i == 0))


def _np_fleet_j(fs):
    return jax.tree_util.tree_map(np.asarray, fs)


def _leaves(fs, stats=None):
    """(name, numpy array) of every counter (if given) and state leaf."""
    out = [] if stats is None else [
        (f"stats.{k}", np.asarray(v)) for k, v in zip(stats._fields, stats)]
    out += [(f"sched.{k}", np.asarray(v)) for k, v in
            zip(fs.sched._fields, fs.sched)]
    out += [(k, np.asarray(v)) for k, v in zip(fs._fields[1:], fs[1:])]
    return out


def _assert_same(ref, got, cols=slice(None)):
    for (name, r), (name_g, g) in zip(ref, got):
        assert name == name_g
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(r[cols], g[cols], err_msg=name)


def _run_both(R, values, bw, fleet_j=None, fleet_t=None):
    fleet_j = make_fleet_j(B, requeue_slots=R) if fleet_j is None else fleet_j
    if fleet_t is None:
        fleet_t = make_fleet(B, requeue_slots=R, device="cpu")
    sj, tj = fleet_run_j(fleet_j, values, bw, params=_params(FleetParams_j, R))
    st, tt = fleet_run(fleet_t, values, bw, params=_params(FleetParams, R))
    return (sj, tj), (st, tt)


@pytest.fixture(scope="module")
def runs():
    values, bw = _population(F, seed=3)
    out = {}
    for R in (4, 0):
        (sj, tj), (st, tt) = _run_both(R, values, bw)
        out[R] = (_np_fleet_j(sj), _leaves(sj, tj),
                  _leaves(fleet_to_numpy(st), stats_to_numpy(tt)), st, tt)
    return out


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_fleet_run_matches_per_scenario(runs, scenario):
    _, ref, got, _, _ = runs[4]
    _assert_same(ref, got, _columns(scenario))


def test_fleet_run_matches_without_requeue(runs):
    _, ref, got, _, _ = runs[0]
    _assert_same(ref, got)


def test_run_exercises_the_engine(runs):
    """The matched run is not trivial: frames complete and fail, HP
    preempts, victims re-queue, LP offloads and widens to 4 cores."""
    stats = dict(runs[4][2])
    for k in ("frames_completed", "hp_failed", "hp_preempted",
              "lp_requeued", "lp_offloaded", "lp_four_core", "lp_failed"):
        assert stats[f"stats.{k}"].sum() > 0, k


@pytest.mark.parametrize("R", [4, 0])
def test_conservation_residual_is_zero(runs, R):
    st, tt = runs[R][3], runs[R][4]
    res = conservation_residual(tt, st.rq_valid.sum(1))
    assert res.shape == (B,) and not res.any()


def test_result_does_not_depend_on_segment_frames(runs):
    values, bw = _population(F, seed=3)
    _, _, want, _, _ = runs[4]
    for seg in (0, 3, F + 5):
        p = dataclasses.replace(_params(FleetParams, 4), segment_frames=seg)
        st, tt = fleet_run(make_fleet(B, device="cpu"), values, bw, params=p)
        _assert_same(want, _leaves(fleet_to_numpy(st), stats_to_numpy(tt)))


def test_run_from_carried_mid_run_state_matches(runs):
    """Both engines continue from the reference's state after the first
    run, the port's copy of it carried across by ``fleet_from_numpy``."""
    mid = runs[4][0]
    carried = fleet_from_numpy(mid, device="cpu")
    _assert_same(_leaves(mid), _leaves(fleet_to_numpy(carried)))
    values, bw = _population(12, seed=11)
    (sj, tj), (st, tt) = _run_both(4, values, bw, fleet_j=mid,
                                   fleet_t=carried)
    _assert_same(_leaves(sj, tj),
                 _leaves(fleet_to_numpy(st), stats_to_numpy(tt)))


def test_fleet_run_leaves_input_untouched():
    values, bw = _population(F, seed=3)
    fleet = make_fleet(B, device="cpu")
    before = _leaves(fleet_to_numpy(fleet))
    fleet_run(fleet, values[:4], bw[:4], params=_params(FleetParams, 4))
    _assert_same(before, _leaves(fleet_to_numpy(fleet)))


def test_run_sweep_summary_matches():
    """The unsharded sweep: 4 cells of 5 seeds in batches of 17 (one
    padded batch), summarised per cell with the checked residual."""
    kw = dict(scenarios=("uniform", "weighted2"),
              congestion_levels=(0.0, 0.3), n_seeds=5, n_frames=F,
              batch_size=B)
    ref = run_sweep_j(SweepConfig_j(**kw, params=_params(FleetParams_j, 4)))
    got = run_sweep(SweepConfig(**kw, params=_params(FleetParams, 4)),
                    device="cpu")
    assert got == ref
    for cell in ref["_sweep"]["cells"]:
        assert got[cell]["conservation_residual"]["max_abs"] == 0


@pytest.mark.parametrize("R", [4, 0])
@pytest.mark.parametrize("seed", [3, 5])
def test_placement_counters_match_the_stats(R, seed):
    """Under a device-timed timer the plain route counts every
    ``fused_place`` call's rows attempted and committed by slot (0 the
    re-queue pass, 1 + d device d's victim re-placement, 5 + 4d + k its
    LP attempt k): the commits are the completions, less the revoked
    ones, which are the preemptions; the LP slots' attempts are the LP
    tasks spawned; the re-placement slots' attempts the preemptions."""
    values, bw = _population(F, seed=seed)
    with profile.PhaseTimer(device_time=True) as t:
        _, stats = fleet_run(make_fleet(B, requeue_slots=R, device="cpu"),
                             values, bw, params=_params(FleetParams, R))
    counts = np.array(t.counters()["fleet/fused_place"])
    total = {k: int(getattr(stats, k).sum()) for k in (
        "lp_completed", "hp_preempted", "lp_spawned")}
    assert counts.shape == (21, 2)
    assert counts[5:, 0].sum() == total["lp_spawned"] > 0
    if R:
        assert counts[:, 1].sum() == (total["lp_completed"]
                                      + total["hp_preempted"])
        assert counts[1:5, 0].sum() == total["hp_preempted"] > 0
    else:
        # no re-queue: nothing is re-placed and no completion is revoked
        assert counts[:, 1].sum() == total["lp_completed"]
        assert not counts[:5].any()
    assert (counts[:, 1] <= counts[:, 0]).all()


@pytest.mark.parametrize("R", [4, 0])
@pytest.mark.parametrize("seed", [3, 5])
def test_hp_commit_counters_match_the_stats(R, seed):
    """Under a device-timed timer each device's HP commit counts its rows
    committed and the rows whose windows the commit changed: the commits
    are the stats' ``hp_completed``, and the HP commit of a run of this
    length changes the windows of most of them."""
    values, bw = _population(F, seed=seed)
    with profile.PhaseTimer(device_time=True) as t:
        _, stats = fleet_run(make_fleet(B, requeue_slots=R, device="cpu"),
                             values, bw, params=_params(FleetParams, R))
    counts = np.array(t.counters()["fleet/hp_commit"])
    assert counts.shape == (4, 2)
    assert counts[:, 0].sum() == int(stats.hp_completed.sum()) > 0
    assert (counts[:, 1] <= counts[:, 0]).all()
    assert counts[:, 1].sum() > counts[:, 0].sum() // 2


def test_fan_out_kernel_is_not_launched_on_cpu(runs):
    assert placement_t.launches_fanout_commit == 0


def test_kernel_is_not_launched_on_cpu(runs):
    assert placement_t.launches == 0


# ---------------------------------------------------------------------------
# device rules
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_fleet(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sweep(SweepConfig(n_seeds=1, n_frames=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet_from_numpy(fleet_to_numpy(make_fleet(2, device="cpu")))


def test_fleet_runs_on_the_device_of_its_tensors():
    values, bw = _population(2, seed=1)
    st, tt = fleet_run(make_fleet(B, device="cpu"), values, bw,
                       params=_params(FleetParams, 4))
    assert st.sched.win_t1.device.type == "cpu"
    assert tt.frames.device.type == "cpu"


@pytest.mark.parametrize("change", [{"mesh_shards": 1}, {"telemetry": True}])
def test_unported_options_raise(change):
    """The two options earlier slices refused (the batch split and the
    telemetry) now run, and leave the results as they were; their own
    tests are ``test_torch_fleet_sharded.py`` and ``test_torch_obs.py``."""
    p = dataclasses.replace(_params(FleetParams, 4), **change)
    values, bw = _population(2, seed=1)
    want = fleet_run(make_fleet(B, device="cpu"), values, bw,
                     params=_params(FleetParams, 4))
    got = fleet_run(make_fleet(B, device="cpu"), values, bw, params=p)
    assert len(got) == 2 + bool(change.get("telemetry"))
    _assert_same(_leaves(fleet_to_numpy(want[0]), stats_to_numpy(want[1])),
                 _leaves(fleet_to_numpy(got[0]), stats_to_numpy(got[1])))
