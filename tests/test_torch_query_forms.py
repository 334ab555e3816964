"""The port's functional query forms against the JAX package: the tensor
forms of ``core/windows.py`` (``find_slot_arrays``, ``multi_find_slot``,
``count_feasible``) and ``core/netlink.py`` (``index_of_torch``,
``reserve_torch`` against ``index_of_jax``, ``reserve_jax``), and the
single-controller placements ``hp_place`` and ``lp_place`` of
``core/tensor_state.py`` against ``core/jax_state.py``, each from the same
``export_state`` of a loaded ``RASScheduler`` (the construction of the
reference's ``benchmarks/bench_query.py``), carried across with
``carry.sched_state_from_numpy``.

Tolerance is exact equality of every output and every state leaf, dtypes
included: the forms are f32 compare, min, max, select, add and floor, with
first-index ties, so 0 ULP is reachable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_state as J
from repro.core import netlink as netlink_j
from repro.core import windows as windows_j
from repro.core.netlink import NetworkLink
from repro.core.scheduler import RASScheduler
from repro.core.tasks import LPRequest, Priority, Task
from repro_torch.carry import sched_state_from_numpy
from repro_torch.core import netlink as netlink_t
from repro_torch.core import tensor_state as S
from repro_torch.core import windows as windows_t

SCALARS = (10.1, 80.3, 17.2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want):
    for g, w in zip(got, want):
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


def _windows(rng, lead, T=2, W=16, ties=True):
    """Random windows, and (``ties``) a share of them starting before q1 so
    that several feasible windows share the earliest start, q1: the
    first-index rule decides."""
    t1 = rng.uniform(0, 60, (*lead, T, W)).astype(np.float32)
    t2 = t1 + rng.uniform(5, 60, (*lead, T, W)).astype(np.float32)
    if ties:
        early = rng.random(t1.shape) < 0.3
        t1 = np.where(early, np.float32(1.0), t1).astype(np.float32)
    valid = rng.random(t1.shape) < 0.6
    return t1, t2, valid


def _both(t1, t2, valid):
    return ([jnp.asarray(x) for x in (t1, t2, valid)],
            [torch.from_numpy(x) for x in (t1, t2, valid)])


# ---------------------------------------------------------------------------
# core/windows.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_find_slot_arrays_matches(seed):
    rng = np.random.default_rng(seed)
    j, t = _both(*_windows(rng, ()))
    scal = SCALARS if seed % 2 else (0.3, 61.7, 2.9)
    _assert_same(windows_t.find_slot_arrays(*t, *scal),
                 windows_j.find_slot_arrays(*j, *scal))


@pytest.mark.parametrize("seed", range(4))
def test_multi_find_slot_and_count_feasible_match(seed):
    rng = np.random.default_rng(10 + seed)
    t1, t2, valid = _windows(rng, (8,))
    valid[rng.random(8) < 0.25] = False          # devices with no window
    j, t = _both(t1, t2, valid)
    got = windows_t.multi_find_slot(*t, *SCALARS)
    _assert_same(got, windows_j.multi_find_slot(*j, *SCALARS))
    _assert_same([windows_t.count_feasible(*t, *SCALARS)],
                 [windows_j.count_feasible(*j, *SCALARS)])
    found = got[0].numpy()
    assert found.any() and not found.all()


def test_first_index_wins_ties():
    t1 = np.full((2, 4), 1.0, np.float32)        # every window starts at q1
    t2 = np.full((2, 4), 90.0, np.float32)
    valid = np.array([[False, True, True, False], [True] * 4])
    j, t = _both(t1, t2, valid)
    got = windows_t.find_slot_arrays(*t, *SCALARS)
    _assert_same(got, windows_j.find_slot_arrays(*j, *SCALARS))
    assert int(got[1]) == 1


def test_forms_on_a_loaded_schedulers_lists():
    """The bench's query: the LP2 lists of a loaded scheduler, with the
    ``inf`` padding of ``to_arrays``, 4 devices and 256 x 4."""
    sched = _loaded()
    arrs = [d.lists["lp2"].to_arrays() for d in sched.devices]
    for reps in (1, 256):
        t1, t2, valid = (np.repeat(np.stack([a[k] for a in arrs]), reps, 0)
                         for k in ("t1", "t2", "valid"))
        j, t = _both(t1, t2, valid)
        _assert_same(windows_t.multi_find_slot(*t, 30.0, 90.0, 17.2),
                     windows_j.multi_find_slot(*j, 30.0, 90.0, 17.2))
        _assert_same([windows_t.count_feasible(*t, 30.0, 90.0, 17.2)],
                     [windows_j.count_feasible(*j, 30.0, 90.0, 17.2)])


# ---------------------------------------------------------------------------
# core/netlink.py
# ---------------------------------------------------------------------------

def _t_p_sweep(link):
    """Timestamps from before t_r - D to past the last bucket: every bucket
    edge, a point inside each bucket, the exponential edges (powers of two
    of base units) and one ulp either side of each."""
    D, t_r = np.float32(link.D), np.float32(link.t_r)
    edges = np.array([b.t1 for b in link.buckets] + [link.buckets[-1].t2],
                     np.float32)
    units = np.arange(-3, 2 ** 14, dtype=np.float32)
    pts = np.concatenate([
        edges, edges + D / 2, t_r + units * D,
        [t_r - np.float32(0.5) * D, t_r - np.float32(1.5) * D],
    ]).astype(np.float32)
    return np.concatenate([pts, np.nextafter(pts, np.float32(-np.inf)),
                           np.nextafter(pts, np.float32(np.inf))])


@pytest.mark.parametrize("bw,now,n_base", [
    (20e6, 0.0, 256), (20e6, 13.7, 256), (3.3e6, 5.0, 8), (50e6, 0.25, 2),
])
def test_index_of_matches(bw, now, n_base):
    link = NetworkLink(bw, now=now, n_base=n_base)
    t_p = _t_p_sweep(link)
    args = (link.t_r, link.D, link.n_base, len(link.buckets))
    got = netlink_t.index_of_torch(torch.from_numpy(t_p), *args)
    want = netlink_j.index_of_jax(jnp.asarray(t_p), *args)
    _assert_same([got], [want])
    # the past (-1) and every bucket after the first are reached (the
    # closed form puts t_r itself in bucket 1)
    assert set(np.unique(got.numpy())) >= {-1, *range(1, len(link.buckets))}
    # a Python float goes through the same f32 rounding
    _assert_same([netlink_t.index_of_torch(float(t_p[7]), *args)],
                 [netlink_j.index_of_jax(float(t_p[7]), *args)])


@pytest.mark.parametrize("seed", range(4))
def test_reserve_matches(seed):
    rng = np.random.default_rng(seed)
    link = NetworkLink(20e6, n_base=16, n_exp=4)
    arrs = link.to_arrays()
    arrs["used"] = np.minimum(arrs["capacity"],
                              rng.integers(0, 3, arrs["used"].shape)
                              ).astype(np.int32)
    if seed == 0:
        arrs["used"] = arrs["capacity"].copy()   # every bucket full
    cols = [arrs[k] for k in ("t1", "t2", "capacity", "used")]
    for t_p in (0.0, float(arrs["t1"][5]), float(arrs["t2"][9]), 1e9):
        _assert_same(
            netlink_t.reserve_torch(*map(torch.from_numpy, cols), t_p),
            netlink_j.reserve_jax(*map(jnp.asarray, cols), t_p))


# ---------------------------------------------------------------------------
# hp_place / lp_place
# ---------------------------------------------------------------------------

def _loaded(n_dev=4, n_tasks=24, seed=0):
    """A RASScheduler loaded as ``benchmarks/bench_query.py`` loads it."""
    s = RASScheduler(n_dev, 20e6, seed=seed)
    rng = np.random.default_rng(seed)
    for i in range(n_tasks // 2):
        t = float(rng.uniform(0, 60))
        req = LPRequest(
            [Task(Priority.LOW, i % n_dev, t, t + 80.0, 0) for _ in range(2)],
            i % n_dev, t,
        )
        s.schedule_lp(req, t)
    return s


@pytest.fixture(scope="module")
def states():
    out = []
    for seed in (0, 3):
        st_j = J.export_state(_loaded(seed=seed))
        st_t = sched_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, st_j), device="cpu")
        out.append((st_j, st_t))
    return out


def test_sched_state_carry_equals_the_ports_export(states):
    sched = _loaded(seed=0)
    _assert_same(S.export_state(sched, device="cpu"), states[0][1])


@pytest.mark.parametrize("now", [0.0, 10.1, 35.0, 61.7, 200.3])
def test_hp_place_matches(states, now):
    found = 0
    for st_j, st_t in states:
        for dev in range(4):
            got = S.hp_place(st_t, dev, now, cfg_idx=0)
            want = J.hp_place(st_j, jnp.asarray(dev), jnp.asarray(now),
                              cfg_idx=0)
            _assert_same(got[:2], want[:2])
            _assert_same(got[2], want[2])
            found += bool(got[0])
    assert found > 0


@pytest.mark.parametrize("n_tasks", [1, 2, 3, 4])
@pytest.mark.parametrize("cfg", ["lp2", "lp4"])
def test_lp_place_matches(states, cfg, n_tasks):
    placed = 0
    for st_j, st_t in states:
        for src, now, dl in ((0, 30.0, 90.0), (2, 10.1, 40.7),
                             (3, 61.7, 150.3)):
            got = S.lp_place(st_t, src, now, dl, cfg_idx=S.CFG_INDEX[cfg],
                             n_tasks=n_tasks)
            want = J.lp_place(st_j, jnp.asarray(src), jnp.asarray(now),
                              jnp.asarray(dl), cfg_idx=J.CFG_INDEX[cfg],
                              n_tasks=n_tasks)
            _assert_same(got[:4], want[:4])
            _assert_same(got[4], want[4])
            placed += int(got[1].sum())
    assert placed > 0


def test_placements_leave_their_input_state(states):
    _, st = states[0]
    before = [x.clone() for x in st]
    S.hp_place(st, 1, 30.0)
    S.lp_place(st, 1, 30.0, 90.0, n_tasks=4)
    _assert_same(st, before)
