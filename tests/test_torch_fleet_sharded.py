"""The port's sharded fleet against the JAX package: splitting the batch
across devices is pure data parallelism (replicas never interact), so
every sharded run of the port must be **bit-identical** to ``repro``'s
unsharded engine — state, stats, telemetry and the sanitized leg alike —
and the sharded sweep's on-device per-cell reduction must reproduce
``repro``'s ``run_sweep(mesh_shards=1)``.

On the host every shard is the CPU device (``fleet/mesh.py``), the
counterpart of the reference's ``--xla_force_host_platform_device_count``,
so shards 1, 2 and 3 all run here; ``repro``'s sharded engine is pinned
bit-identical to its unsharded one by its own tests, so the port's shards
are held to ``repro``'s unsharded run. Tolerances: exact for state,
stats, records, counts and residuals; cell means within rel 1e-5 / abs
1e-5, the reference's own (``tests/test_fleet_sharded.py``), since the
moments are f32 sums in another order.

Both engines run the plain placement path; the JAX runs share (B=16 or
13, F=8, DEV=4) signatures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleet as fleet_j
import repro.fleet.metrics as metrics_j
import repro_torch.fleet as fleet_t
import repro_torch.fleet.metrics as metrics_t
from repro.fleet import make_workload
from repro_torch.analysis import sanitize
from repro_torch.carry import fleet_to_numpy, stats_to_numpy
from repro_torch.fleet import (
    FleetParams, SweepConfig, available_shards, fleet_devices, fleet_run,
    make_fleet, run_sweep, shard_pad,
)
from repro_torch.fleet.state import fleet_shape, track_counts
from repro_torch.kernels.placement import placement as placement_t
from repro_torch.obs import profile

B, F, DEV = 16, 8, 4
B_ODD = 13                      # pads to 14 on 2 shards, 15 on 3


def _params(cls, **kw):
    return cls(n_devices=DEV, placement_backend="ref", **kw)


PARAMS = _params(FleetParams)


def _wl(batch=B, seed=3, congestion=0.3, scenario="uniform"):
    return make_workload(scenario, batch, F, DEV, seed=seed,
                         congestion=congestion)


def _run(params, wl, batch=B):
    fleet = make_fleet(batch, DEV, requeue_slots=params.requeue_slots,
                       device="cpu")
    return fleet_run(fleet, wl.values, wl.bw_scale, params=params)


def _run_j(params, wl, batch=B):
    fleet = fleet_j.make_fleet(batch, DEV, requeue_slots=params.requeue_slots)
    out = fleet_j.fleet_run(fleet, wl.values, wl.bw_scale, params=params)
    return jax.tree_util.tree_map(np.asarray, out[:2]) + tuple(out[2:])


def _leaves(state, stats):
    """(name, numpy array) of every state leaf and counter."""
    if isinstance(state.link_free, torch.Tensor):
        state, stats = fleet_to_numpy(state), stats_to_numpy(stats)
    out = [(f"sched.{k}", np.asarray(v))
           for k, v in zip(state.sched._fields, state.sched)]
    out += [(k, np.asarray(v)) for k, v in zip(state._fields[1:], state[1:])]
    out += [(f"stats.{k}", np.asarray(v))
            for k, v in zip(stats._fields, stats)]
    return out


def _assert_same(a, b):
    for (name, x), (name_b, y) in zip(a, b, strict=True):
        assert name == name_b
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


@pytest.fixture(scope="module")
def reference():
    """``repro``'s unsharded (state, stats) at the shared signature."""
    return _leaves(*_run_j(_params(fleet_j.FleetParams), _wl()))


@pytest.fixture(scope="module")
def reference_odd():
    """``repro``'s unsharded run at the odd batch, telemetry on."""
    pt = _params(fleet_j.FleetParams, telemetry=True, telemetry_every=2)
    state, stats, rec = _run_j(pt, _wl(B_ODD, seed=7, scenario="weighted2"),
                               batch=B_ODD)
    return _leaves(state, stats), rec


# ---------------------------------------------------------------------------
# the sharded engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [0, 1, 2, 3])
def test_sharded_bit_identical(reference, shards):
    """B=16 over 1, 2 and 3 shards (3 pads to 18), and unsharded."""
    st, stats = _run(dataclasses.replace(PARAMS, mesh_shards=shards), _wl())
    _assert_same(reference, _leaves(st, stats))


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_batch_pad_bit_identical(reference_odd, shards):
    """B=13 does not divide 2 or 3 shards: the engine pads with no-op
    replicas and trims them from every output."""
    p = _params(FleetParams, mesh_shards=shards)
    st, stats = _run(p, _wl(B_ODD, seed=7, scenario="weighted2"),
                     batch=B_ODD)
    assert stats.hp_completed.shape == (B_ODD,)
    assert st.sched.win_t1.shape[0] == B_ODD
    _assert_same(reference_odd[0], _leaves(st, stats))


@pytest.mark.parametrize("shards", [0, 1, 2])
def test_telemetry_composes_with_sharding(reference_odd, shards):
    """Telemetry on shards at an odd B: the record equals ``repro``'s
    bit for bit, with the padded replicas trimmed, and the state and
    stats are untouched."""
    pt = _params(FleetParams, telemetry=True, telemetry_every=2,
                 mesh_shards=shards)
    st, stats, rec = _run(pt, _wl(B_ODD, seed=7, scenario="weighted2"),
                          batch=B_ODD)
    want_leaves, want = reference_odd
    _assert_same(want_leaves, _leaves(st, stats))
    assert rec.n_replicas == B_ODD
    assert np.array_equal(want.ticks, rec.ticks)
    for f in want.series._fields:
        x, y = np.asarray(getattr(want.series, f)), getattr(rec.series, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("shards", [1, 2])
def test_sanitize_composes_with_sharding(monkeypatch, reference, shards):
    """``REPRO_SANITIZE=1`` checks every shard; the checked sharded leg
    agrees with the unchecked unsharded reference."""
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    st, stats = _run(dataclasses.replace(PARAMS, mesh_shards=shards), _wl())
    _assert_same(reference, _leaves(st, stats))


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_spans_and_counters(reference_odd, shards):
    """Under a device-timed timer the sharded run stays bit-identical,
    each shard's tick is a span of its own, and the shards' placement
    counters sum to the unsharded run's (padded replicas attempt
    nothing)."""
    wl = _wl(B_ODD, seed=7, scenario="weighted2")
    with profile.PhaseTimer(device_time=True) as one:
        _run(PARAMS, wl, batch=B_ODD)
    with profile.PhaseTimer(device_time=True) as split:
        st, stats = _run(_params(FleetParams, mesh_shards=shards), wl,
                         batch=B_ODD)
    _assert_same(reference_odd[0], _leaves(st, stats))
    assert split.counters() == one.counters()
    assert split.summary()["fleet/tick"]["count"] == F * shards


def test_sanitize_trips_on_a_corrupt_shard(monkeypatch):
    """A corrupted window in the second shard's rows raises."""
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    fleet = make_fleet(B, DEV, device="cpu")
    fleet.sched.win_t1[B - 1, 0, 0, 0, 0] = 9.0
    fleet.sched.win_t2[B - 1, 0, 0, 0, 0] = 1.0
    fleet.sched.win_valid[B - 1, 0, 0, 0, 0] = True
    wl = _wl()
    with pytest.raises(sanitize.SanitizeError, match="window order"):
        fleet_run(fleet, wl.values, wl.bw_scale,
                  params=dataclasses.replace(PARAMS, mesh_shards=2))


def test_sharded_run_leaves_input_untouched():
    fleet = make_fleet(B_ODD, DEV, device="cpu")
    before = _leaves(fleet, stats_to_numpy(metrics_t.init_stats(
        B_ODD, device="cpu")))
    wl = _wl(B_ODD)
    fleet_run(fleet, wl.values, wl.bw_scale,
              params=dataclasses.replace(PARAMS, mesh_shards=2))
    _assert_same(before, _leaves(fleet, stats_to_numpy(
        metrics_t.init_stats(B_ODD, device="cpu"))))


def test_kernel_is_not_launched_on_cpu():
    _run(dataclasses.replace(PARAMS, mesh_shards=2), _wl())
    assert placement_t.launches == 0


# ---------------------------------------------------------------------------
# the sharded sweep and its on-device reduction
# ---------------------------------------------------------------------------

SWEEP = dict(scenarios=("uniform",), congestion_levels=(0.0, 0.3),
             n_seeds=8, n_frames=F, n_devices=DEV, batch_size=B)
#: 4 cells x 5 seeds in batches of 16: the second batch is 4 replicas and
#: 12 of owner -1
SWEEP_TAIL = dict(SWEEP, scenarios=("uniform", "weighted2"), n_seeds=5)


@pytest.fixture(scope="module")
def sweeps_j():
    """``repro``'s sharded sweeps on its one-device mesh."""
    return {name: fleet_j.run_sweep(fleet_j.SweepConfig(
        **kw, mesh_shards=1, params=_params(fleet_j.FleetParams)))
        for name, kw in (("main", SWEEP), ("tail", SWEEP_TAIL))}


def _assert_sweep_matches(ref, out, shards):
    assert out["_sweep"]["mesh"]["shards"] == shards
    assert out["_sweep"]["cells"] == ref["_sweep"]["cells"]
    assert out["_sweep"]["total_replicas"] == ref["_sweep"]["total_replicas"]
    for cell in ref["_sweep"]["cells"]:
        summary, got = ref[cell], out[cell]
        assert got.keys() == summary.keys()
        assert got["replicas"] == summary["replicas"]
        assert got["conservation_residual"]["max_abs"] == 0
        for key, val in summary.items():
            if not (isinstance(val, dict) and "mean" in val):
                continue
            assert got[key]["mean"] == pytest.approx(
                val["mean"], rel=1e-5, abs=1e-5), (cell, key)
            if "max_abs" in val:
                assert got[key]["max_abs"] == val["max_abs"]


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("case", ["main", "tail"])
def test_sharded_sweep_matches_reference(sweeps_j, case, shards):
    kw = SWEEP if case == "main" else SWEEP_TAIL
    out = run_sweep(SweepConfig(**kw, mesh_shards=shards,
                                params=_params(FleetParams)), device="cpu")
    _assert_sweep_matches(sweeps_j[case], out, shards)
    assert out["_sweep"]["batch_size"] == B
    assert out["_sweep"]["mesh"]["replicas_per_shard"] == B // shards


def test_sharded_sweep_matches_host_reduction():
    """The on-device reduction reproduces the port's host-side
    ``summarize`` means (3 shards: the batch pads 16 -> 18)."""
    cfg = SweepConfig(**SWEEP, params=_params(FleetParams))
    ref = run_sweep(cfg, device="cpu")
    out = run_sweep(dataclasses.replace(cfg, mesh_shards=3), device="cpu")
    assert out["_sweep"]["batch_size"] == 18
    _assert_sweep_matches(ref, out, 3)


def _random_batch(seed, batch=64, n_cells=3):
    rng = np.random.default_rng(seed)
    stats = {f: rng.integers(0, 40, batch).astype(np.int32)
             for f in metrics_t.FleetStats._fields}
    stats["start_delay_sum"] = rng.uniform(0, 90, batch).astype(np.float32)
    stats["comm_busy"] = rng.uniform(0, 30, batch).astype(np.float32)
    stats["lp_spawned"] = (stats["lp_completed"] + stats["lp_failed"]
                           + stats["missed_by_preemption"]
                           + rng.integers(0, 2, batch).astype(np.int32))
    rq_valid = rng.random((batch, 4)) < 0.2
    owner = rng.integers(-1, n_cells, batch).astype(np.int32)
    return stats, rq_valid, owner


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_cell_moments_matches_reference(shards):
    """``cell_moments`` on seeded counters (residuals nonzero, some
    owners -1) against the reference's jitted one: counts and residual
    maxima exact, means and second moments within 1e-5."""
    stats, rq_valid, owner = _random_batch(seed=shards)
    ref = jax.jit(lambda s, r, o: metrics_j.cell_moments(
        s, r, o, n_cells=3, n_frames=95))(
        metrics_j.FleetStats(**stats), jnp.asarray(rq_valid),
        jnp.asarray(owner))
    got = metrics_t.cell_moments(
        metrics_t.FleetStats(**{k: torch.as_tensor(v)
                                for k, v in stats.items()}),
        torch.as_tensor(rq_valid), torch.as_tensor(owner), n_cells=3,
        n_frames=95, shards=shards)
    assert np.array_equal(np.asarray(ref.count), got.count.numpy())
    assert np.array_equal(np.asarray(ref.resid_max_abs),
                          got.resid_max_abs.numpy())
    assert got.resid_max_abs.dtype == torch.int32
    assert np.asarray(ref.resid_max_abs).max() > 0
    for name in ("mean", "m2"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_merge_and_summarize_cells_match_reference():
    """The host side of the reduction (float64) is the reference's."""
    parts = []
    for seed in (1, 2):
        stats, rq_valid, owner = _random_batch(seed)
        parts.append(metrics_t.cell_moments(
            metrics_t.FleetStats(**{k: torch.as_tensor(v)
                                    for k, v in stats.items()}),
            torch.as_tensor(rq_valid), torch.as_tensor(owner), n_cells=3,
            n_frames=95))
    got = ref = None
    for m in parts:
        got = metrics_t.merge_cell_moments(got, m)
        ref = metrics_j.merge_cell_moments(
            ref, metrics_j.CellMoments(*(x.numpy() for x in m)))
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert metrics_t.cell_rate_keys() == metrics_j.cell_rate_keys()
    assert metrics_t.summarize_cells(got) == metrics_j.summarize_cells(ref)


# ---------------------------------------------------------------------------
# devices, padding, shapes, exports
# ---------------------------------------------------------------------------

def test_mesh_oversubscription_raises():
    with pytest.raises(ValueError, match="device"):
        fleet_devices(available_shards() + 1, "cuda")
    with pytest.raises(ValueError):
        fleet_devices(0, "cpu")


def test_fleet_devices_on_the_host():
    assert fleet_devices(3, "cpu") == [torch.device("cpu")] * 3


def test_sharded_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet_devices(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sweep(SweepConfig(n_seeds=1, n_frames=1, mesh_shards=1))


def test_shard_pad():
    assert shard_pad(16, 8) == 0
    assert shard_pad(12, 8) == 4
    assert shard_pad(1, 8) == 7
    assert shard_pad(12, 1) == 0
    for b in range(1, 20):
        for s in range(1, 6):
            assert shard_pad(b, s) == fleet_j.shard_pad(b, s)


def test_fleet_shape_and_track_counts_match_reference():
    assert fleet_shape(make_fleet(5, DEV, device="cpu")) == tuple(
        fleet_j.state.fleet_shape(fleet_j.make_fleet(5, DEV)))
    assert track_counts() == fleet_j.state.track_counts()


def test_fleet_exports_match_reference():
    assert fleet_t.__all__ == sorted(
        "fleet_devices" if n == "fleet_mesh" else n
        for n in fleet_j.__all__)
    assert fleet_t.FLEET_AXIS == fleet_j.FLEET_AXIS
