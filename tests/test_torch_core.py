"""The port's core against the JAX package: the copied framework-neutral
modules are pinned to their originals, and the tensor state functions
(`fanout_commit`, `_trim_tracks`, `compact_tracks`) reproduce
`core/jax_state.py` on the same numpy inputs.

Tolerance is exact equality throughout: the reference math is f32
compare, min, max, select and add with first-index tie-breaks, so the
port can and must reproduce it to the bit once its sums run in the same
order. A last-bit difference in a track overlap can flip a tie in the
track ranking and trim another track.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_state as J
from repro.core import tasks as tasks_j
from repro.core.scheduler import RASScheduler as RASScheduler_j
from repro.core.tasks import LPRequest as LPRequest_j
from repro.core.tasks import Priority as Priority_j
from repro.core.tasks import Task as Task_j
from repro.fleet.scenarios import make_workload as make_workload_j
from repro.fleet.scenarios import scenario_names
from repro_torch.core import tasks as tasks_t
from repro_torch.core import tensor_state as S
from repro_torch.core.scheduler import RASScheduler as RASScheduler_t
from repro_torch.core.tasks import LPRequest as LPRequest_t
from repro_torch.core.tasks import Priority as Priority_t
from repro_torch.core.tasks import Task as Task_t
from repro_torch.fleet.scenarios import make_workload as make_workload_t
from repro_torch.fleet.scenarios import scenario_names as scenario_names_t

SRC = Path(__file__).resolve().parents[1] / "src"
N, DEV, CFG, T, W = 13, 4, 3, 2, 16

_fanout_j = jax.jit(J.fanout_commit)
_compact_j = jax.jit(J.compact_tracks)
_trim_j = jax.jit(J._trim_tracks)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _assert_same(ref, got, names):
    for name, r, g in zip(names, ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(), err_msg=name)


# ---------------------------------------------------------------------------
# the copies are pinned
# ---------------------------------------------------------------------------

def test_task_constants_and_configs_match():
    for name in ("FRAME_PERIOD", "HP_PROC_TIME", "LP2_PROC_TIME",
                 "LP4_PROC_TIME", "LP_PAD_FRACTION", "DEVICE_CORES",
                 "MAX_IMAGE_BYTES"):
        assert getattr(tasks_t, name) == getattr(tasks_j, name), name
    assert ([dataclasses.astuple(c) for c in tasks_t.ALL_CONFIGS]
            == [dataclasses.astuple(c) for c in tasks_j.ALL_CONFIGS])
    assert ([c.padded_time for c in tasks_t.ALL_CONFIGS]
            == [c.padded_time for c in tasks_j.ALL_CONFIGS])


def test_state_tables_match():
    assert S.BIG == J.BIG
    assert S.CFG_INDEX == J.CFG_INDEX
    np.testing.assert_array_equal(S.CFG_CORES, J.CFG_CORES)
    np.testing.assert_array_equal(S.CFG_TRACKS, J.CFG_TRACKS)
    np.testing.assert_array_equal(S.OCC_TABLE, J.OCC_TABLE)


def _loaded(sched_cls, req_cls, task_cls, prio, seed):
    s = sched_cls(4, 20e6, seed=seed)
    rng = np.random.default_rng(seed)
    for i in range(3):
        t = float(rng.uniform(0, 30))
        req = req_cls([task_cls(prio.LOW, i % 4, t, t + 60.0, 0)
                       for _ in range(2)], i % 4, t)
        s.schedule_lp(req, t)
    return s


@pytest.mark.parametrize("seed", [None, 0, 1])
def test_export_state_matches(seed):
    """``export_state`` of a fresh scheduler (``seed=None``) and of loaded
    ones gives the reference's arrays, array for array."""
    if seed is None:
        sj, st = RASScheduler_j(4, 20e6), RASScheduler_t(4, 20e6)
    else:
        sj = _loaded(RASScheduler_j, LPRequest_j, Task_j, Priority_j, seed)
        st = _loaded(RASScheduler_t, LPRequest_t, Task_t, Priority_t, seed)
    ref = J.export_state(sj)
    got = S.export_state(st, device="cpu")
    for name in J.SchedState._fields:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(r, g, err_msg=name)


def test_scenario_registry_matches():
    assert scenario_names_t() == scenario_names()


@pytest.mark.parametrize("scenario", scenario_names())
def test_make_workload_matches(scenario):
    for seed in (0, 7):
        for congestion in (0.0, 0.3):
            r = make_workload_j(scenario, 5, 12, seed=seed,
                                congestion=congestion)
            g = make_workload_t(scenario, 5, 12, seed=seed,
                                congestion=congestion)
            for a, b in zip(r, g):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# fan-out commit, trim and compaction
# ---------------------------------------------------------------------------

def _windows(seed, n=N, sort=False):
    """Random windows: overlapping and unsorted unless ``sort``, so one
    commit often cuts three or more windows of a track."""
    rng = np.random.default_rng(seed)
    t1 = rng.uniform(0, 50, (n, DEV, CFG, T, W)).astype(np.float32)
    t2 = (t1 + rng.uniform(0.1, 30, t1.shape)).astype(np.float32)
    valid = rng.random(t1.shape) < 0.6
    if sort:
        order = np.argsort(np.where(valid, t1, 1e9), axis=-1)
        t1, t2, valid = (np.take_along_axis(x, order, -1)
                         for x in (t1, t2, valid))
    return t1, t2, valid


def _commit_args(seed):
    rng = np.random.default_rng(seed + 1000)
    t1, t2, valid = _windows(seed)
    md = rng.uniform(0.5, 8, (N, CFG)).astype(np.float32)
    dev = rng.integers(0, DEV, N).astype(np.int32)
    cfg = rng.integers(0, CFG, N).astype(np.int32)
    s = rng.uniform(0, 50, N).astype(np.float32)
    e = (s + rng.uniform(0.5, 30, N)).astype(np.float32)
    do = rng.random(N) < 0.8
    return t1, t2, valid, md, dev, cfg, s, e, do


def _tie_args():
    """Tracks whose overlaps tie exactly: every row commits [10, 20) on
    device 0, and each list's two tracks overlap it by the same 6 s — in
    three windows on one track and two on the other — so the first track
    must win every rank."""
    t1 = np.full((N, DEV, CFG, T, W), 1e30, np.float32)
    t2 = t1.copy()
    valid = np.zeros(t1.shape, bool)
    for c in range(CFG):
        for w, (a, b) in enumerate([(10.0, 12.0), (13.0, 15.0),
                                    (16.0, 18.0)]):
            t1[:, 0, c, 0, w], t2[:, 0, c, 0, w] = a, b
            valid[:, 0, c, 0, w] = True
        for w, (a, b) in enumerate([(9.0, 13.0), (17.0, 21.0)]):
            t1[:, 0, c, 1, w], t2[:, 0, c, 1, w] = a, b
            valid[:, 0, c, 1, w] = True
    md = np.full((N, CFG), 0.25, np.float32)
    dev = np.zeros(N, np.int32)
    cfg = (np.arange(N) % CFG).astype(np.int32)
    s = np.full(N, 10.0, np.float32)
    e = np.full(N, 20.0, np.float32)
    do = np.ones(N, bool)
    return t1, t2, valid, md, dev, cfg, s, e, do


_COMMIT_OUT = ("t1", "t2", "valid", "n_dropped", "time_dropped")


@pytest.mark.parametrize("seed", range(6))
def test_fanout_commit_matches(seed):
    args = _commit_args(seed)
    ref = _fanout_j(*args)
    got = S.fanout_commit(*_t(*args))
    _assert_same(ref, got, _COMMIT_OUT)


def test_fanout_commit_equal_overlap_ties_match():
    args = _tie_args()
    ref = _fanout_j(*args)
    got = S.fanout_commit(*_t(*args))
    _assert_same(ref, got, _COMMIT_OUT)
    # where one track is cut (an hp or lp2 task), it is the first: nothing
    # of [10, 20) is left on track 0, and track 1 keeps its windows
    one = args[5] < 2
    nt1, nv = got[0].numpy()[one], got[2].numpy()[one]
    assert not nv[:, 0, :, 0, :3].any()
    assert nv[:, 0, :, 1, :2].all()
    np.testing.assert_array_equal(nt1[:, 0, :, 1, :2],
                                  args[0][one][:, 0, :, 1, :2])


def test_fanout_commit_leaves_inputs_and_masked_rows():
    args = list(_commit_args(3))
    args[8] = np.zeros(N, bool)
    tens = _t(*args)
    before = [x.clone() for x in tens]
    out = S.fanout_commit(*tens)
    for a, b in zip(tens, before):
        assert torch.equal(a, b)
    for a, b in zip(out[:3], before[:3]):
        assert torch.equal(a, b)
    assert not out[3].any()


@pytest.mark.parametrize("seed", range(3))
def test_trim_tracks_matches(seed):
    rng = np.random.default_rng(seed + 2000)
    t1, t2, valid = _windows(seed, n=N)
    s = rng.uniform(0, 50, (N, DEV, CFG, T, 1)).astype(np.float32)
    e = (s + rng.uniform(0.5, 20, s.shape)).astype(np.float32)
    md = rng.uniform(0.5, 6, (N, DEV, CFG, T, 1)).astype(np.float32)
    active = rng.random((N, DEV, CFG, T, 1)) < 0.7
    args = (t1, t2, valid, s, e, md, active)
    ref = _trim_j(*args)
    got = S._trim_tracks(*_t(*args))
    _assert_same(ref, got, _COMMIT_OUT)


@pytest.mark.parametrize("seed", range(4))
def test_compact_tracks_matches(seed):
    t1, t2, valid = _windows(seed, sort=seed % 2 == 0)
    # abutting and duplicate starts: merges and equal sort keys
    t1[:, :, :, :, 1] = t2[:, :, :, :, 0]
    t1[:, :, :, :, 3] = t1[:, :, :, :, 2]
    ref = _compact_j(t1, t2, valid)
    got = S.compact_tracks(*_t(t1, t2, valid))
    _assert_same(ref, got, ("t1", "t2", "valid"))


def test_compact_state_matches():
    t1, t2, valid = _windows(11)
    st = J.SchedState(t1, t2, valid, *([np.zeros(1, np.float32)] * 5))
    ref = jax.jit(J.compact_state)(st)
    got = S.compact_state(S.SchedState(*_t(t1, t2, valid),
                                       *([torch.zeros(1)] * 5)))
    _assert_same(ref[:3], got[:3], ("t1", "t2", "valid"))


def test_seq_sum_is_the_reference_order():
    """XLA sums an f32 row of 16 on the host strictly left to right;
    ``_seq_sum`` does the same, where ``torch.sum`` may not."""
    x = np.random.default_rng(5).uniform(0, 30, (4096, 16)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(x))
    np.testing.assert_array_equal(ref, np.cumsum(x, axis=-1)[:, -1])
    np.testing.assert_array_equal(ref, S._seq_sum(torch.from_numpy(x)))


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def test_port_imports_without_jax_or_repro():
    """Every module of the port imports in a process where ``jax`` and
    ``repro`` cannot be imported at all."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
