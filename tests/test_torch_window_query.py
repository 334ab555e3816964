"""The port's window query against the JAX package: the plain versions of
``window_query`` and ``window_query_batched`` against the Pallas kernels in
interpret mode and against their ``ref.py`` oracles, the dispatchers'
backend rules, and the fleet's HP query, which now goes through
``window_query_batched_op``.

Tolerance is exact equality, bit for bit: the query is f32 max, min,
compare, select and one add, so 0 ULP is reachable. The sweeps are seeded
with numpy and compared with the JAX package in f32, never with a float64
Python query: where ``start + dur`` meets ``min(t2, deadline)`` exactly,
f32 and float64 disagree, and the cases below build such ties on purpose.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet.engine import _hp_query as hp_query_j
from repro.kernels.window_query.ref import window_query_batched_ref as wqb_j
from repro.kernels.window_query.ref import window_query_ref as wq_j
from repro.kernels.window_query.window_query import (
    window_query as wq_pallas, window_query_batched as wqb_pallas,
)
from repro_torch.core.tensor_state import BIG as STATE_BIG
from repro_torch.core.tensor_state import SchedState
from repro_torch.fleet import engine as engine_t
from repro_torch.kernels.window_query import window_query as wq_mod
from repro_torch.kernels.window_query.ops import (
    window_query_batched_op, window_query_op,
)
from repro_torch.kernels.window_query.ref import (
    BIG, window_query_batched_ref, window_query_ref,
)

#: query parameters that f32 cannot represent, as the fleet and the
#: reference's tests use them
Q1, DEADLINE, DUR = 10.1, 80.3, 17.2


def _windows(rng, lead, T, W):
    t1 = rng.uniform(0, 100, size=(*lead, T, W)).astype(np.float32)
    t2 = t1 + rng.uniform(1, 50, size=(*lead, T, W)).astype(np.float32)
    valid = rng.random((*lead, T, W)) < 0.7
    return t1, t2, valid


def _tie(t1, t2, valid, rng, q1, dur, deadline=None, frac=0.3):
    """Set ``t2`` of a ``frac`` share of the windows to the f32 sum
    ``max(t1, q1) + dur`` (feasible on the boundary) or one ulp below it
    (infeasible); with ``deadline`` (an f32 array broadcasting to the rows)
    set, the same for the deadline of a share of the rows. Returns the new
    t2 and deadline."""
    q1, dur = np.float32(q1), np.float32(dur)
    edge = np.maximum(t1, q1) + dur
    pick = rng.random(t1.shape) < frac
    below = rng.random(t1.shape) < 0.5
    t2 = np.where(pick, np.where(below, np.nextafter(edge, np.float32(0)),
                                 edge), t2).astype(np.float32)
    valid[pick] = True
    if deadline is not None:
        # a row's deadline on the boundary of its first window
        rows = rng.random(deadline.shape) < 0.5
        first = edge.reshape(*edge.shape[:-2], -1)[..., 0]
        deadline = np.where(rows, first, deadline).astype(np.float32)
    return t2, deadline


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_bits(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------

#: (Dev, T, W, block_dev): the reference's sweep shapes and its padded
#: case (Dev 6 in blocks of 4)
UNBATCHED = [(4, 2, 8, 64), (64, 3, 16, 64), (300, 2, 32, 64), (6, 2, 16, 4)]


@pytest.mark.parametrize("Dev,T,W,bd", UNBATCHED)
def test_window_query_matches_pallas_and_oracle(Dev, T, W, bd):
    rng = np.random.default_rng(Dev)
    t1, t2, valid = _windows(rng, (Dev,), T, W)
    valid[rng.random(Dev) < 0.25] = False      # devices with no window
    args = (Q1, DEADLINE, DUR)
    got = window_query_ref(*_t(t1, t2, valid), *args)
    pallas = wq_pallas(jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(valid),
                       *args, block_dev=bd, interpret=True)
    oracle = wq_j(jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(valid), *args)
    _assert_bits(got, pallas)
    _assert_bits(got, oracle)
    assert 0 < int(got[0].sum()) < Dev


#: (B, Dev, T, W, block_dev): the fleet's geometry, the reference's padded
#: fleet tile (B 3 x Dev 6 in blocks of 4), and a wider list
BATCHED = [(8, 4, 2, 16, 256), (3, 6, 2, 16, 4), (5, 3, 3, 16, 2)]


@pytest.mark.parametrize("B,Dev,T,W,bd", BATCHED)
def test_window_query_batched_matches_pallas_and_oracle(B, Dev, T, W, bd):
    rng = np.random.default_rng(100 + B)
    t1, t2, valid = _windows(rng, (B, Dev), T, W)
    q1 = rng.uniform(0, 60, (B, Dev)).astype(np.float32)
    dl = q1 + rng.uniform(10, 80, (B, Dev)).astype(np.float32)
    dur = rng.uniform(1, 30, (B, Dev)).astype(np.float32)
    got = window_query_batched_ref(*_t(t1, t2, valid, q1, dl, dur))
    jx = [jnp.asarray(x) for x in (t1, t2, valid, q1, dl, dur)]
    _assert_bits(got, wqb_pallas(*jx, block_dev=bd, interpret=True))
    _assert_bits(got, wqb_j(*jx))


@pytest.mark.parametrize("seed", range(6))
def test_window_query_ties_and_unrepresentable_scalars(seed):
    """Seeded sweep: q1, deadline and dur that f32 rounds, and windows whose
    ``start + dur`` lands exactly on ``t2`` (or one ulp short of it), so
    the ``<=`` decides; compared with the Pallas kernel in f32."""
    rng = np.random.default_rng(seed)
    q1 = float(rng.choice([10.1, 0.3, 33.3, 61.7]))
    dur = float(rng.choice([17.2, 0.1, 2.9]))
    deadline = q1 + float(rng.choice([40.7, 90.1, 17.2]))
    t1, t2, valid = _windows(rng, (64,), 2, 16)
    t2, _ = _tie(t1, t2, valid, rng, q1, dur)
    got = window_query_ref(*_t(t1, t2, valid), q1, deadline, dur)
    _assert_bits(got, wq_pallas(jnp.asarray(t1), jnp.asarray(t2),
                                jnp.asarray(valid), q1, deadline, dur,
                                block_dev=16, interpret=True))
    # the sweep reaches the boundary: valid windows with start + dur == t2
    # (in f32) that the deadline does not cut
    edge = np.maximum(t1, np.float32(q1)) + np.float32(dur)
    assert (valid & (edge == t2) & (t2 <= np.float32(deadline))).any()


@pytest.mark.parametrize("seed", range(4))
def test_window_query_batched_ties(seed):
    rng = np.random.default_rng(50 + seed)
    B, Dev = 7, 4
    t1, t2, valid = _windows(rng, (B, Dev), 2, 16)
    q1 = np.full((B, Dev), 10.1, np.float32)
    dur = np.full((B, Dev), 17.2, np.float32)
    dl = q1 + np.float32(60.3)
    t2, dl = _tie(t1, t2, valid, rng, q1[..., None, None],
                  dur[..., None, None], deadline=dl)
    got = window_query_batched_ref(*_t(t1, t2, valid, q1, dl, dur))
    jx = [jnp.asarray(x) for x in (t1, t2, valid, q1, dl, dur)]
    _assert_bits(got, wqb_pallas(*jx, block_dev=4, interpret=True))


def test_window_query_batched_takes_scalars_like_the_reference():
    rng = np.random.default_rng(9)
    t1, t2, valid = _windows(rng, (4, 4), 2, 16)
    got = window_query_batched_ref(*_t(t1, t2, valid), Q1, DEADLINE, DUR)
    _assert_bits(got, wqb_j(jnp.asarray(t1), jnp.asarray(t2),
                            jnp.asarray(valid), Q1, DEADLINE, DUR))


def test_nothing_found_gives_big():
    t1 = np.full((3, 2, 4), 50.0, np.float32)
    t2 = t1 + np.float32(1.0)
    valid = np.ones(t1.shape, bool)
    found, start = window_query_ref(*_t(t1, t2, valid), 0.0, 100.0, 5.0)
    assert found.tolist() == [0, 0, 0] and found.dtype == torch.int32
    assert (start == torch.tensor(BIG, dtype=torch.float32)).all()


# ---------------------------------------------------------------------------
# dispatchers
# ---------------------------------------------------------------------------

def test_batched_op_reads_a_strided_view_as_its_copy():
    """The fleet passes ``win_*[:, d:d+1, HP_IDX]``, a [B,1,T,W] view of the
    state; the dispatcher answers as for a contiguous copy."""
    rng = np.random.default_rng(3)
    t1, t2, valid = _windows(rng, (9, 4, 3), 2, 16)
    t1, t2, valid = _t(t1, t2, valid)
    q1 = torch.from_numpy(rng.uniform(0, 50, (9, 1)).astype(np.float32))
    dl = q1 + 40.3
    dur = torch.from_numpy(rng.uniform(1, 9, (9, 3)).astype(np.float32))
    for d in range(4):
        views = [x[:, d:d + 1, 0] for x in (t1, t2, valid)]
        assert not views[0].is_contiguous()
        got = window_query_batched_op(*views, q1, dl, dur[:, :1])
        want = window_query_batched_op(*[v.contiguous() for v in views], q1,
                                       dl, dur[:, :1].contiguous())
        _assert_bits(got, want)


def test_ops_take_int_valid_and_default_to_the_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    t1, t2, valid = _t(*_windows(rng, (2, 5), 2, 8))
    before = (wq_mod.launches, wq_mod.launches_batched)
    _assert_bits(window_query_batched_op(t1, t2, valid.int(), Q1, DEADLINE,
                                         DUR),
                 window_query_batched_ref(t1, t2, valid, Q1, DEADLINE, DUR))
    _assert_bits(window_query_op(t1[0], t2[0], valid[0].int(), Q1, DEADLINE,
                                 DUR, backend="ref"),
                 window_query_ref(t1[0], t2[0], valid[0], Q1, DEADLINE, DUR))
    assert (wq_mod.launches, wq_mod.launches_batched) == before


@pytest.mark.parametrize("op,args", [
    (window_query_op, (Q1, DEADLINE, DUR)),
    (window_query_batched_op, (Q1, DEADLINE, DUR)),
])
def test_kernel_backend_raises_on_cpu_tensors(op, args):
    rng = np.random.default_rng(5)
    lead = (4,) if op is window_query_op else (2, 4)
    xs = _t(*_windows(rng, lead, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        op(*xs, *args, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        op(*xs, *args, backend="pallas")


def test_launch_grid_covers_every_row():
    for rows in (1, 7, 8, 9, 300, 8192 * 4, 262_144):
        (blocks,) = wq_mod.launch_grid(rows)
        assert (blocks - 1) * wq_mod.ROWS_PER_BLOCK < rows
        assert blocks * wq_mod.ROWS_PER_BLOCK >= rows


# ---------------------------------------------------------------------------
# the fleet's HP query
# ---------------------------------------------------------------------------

def _hp_query_inline(st, dev, now, dur, deadline):
    """The port's HP query before it went through the window-query
    dispatcher: the same masked min-reduce, with the engine's BIG (1e30)."""
    t1 = st.win_t1[:, dev, engine_t.HP_IDX]
    t2 = st.win_t2[:, dev, engine_t.HP_IDX]
    valid = st.win_valid[:, dev, engine_t.HP_IDX]
    nowb = now[:, None, None]
    durb = dur[:, None, None]
    deadline = deadline[:, None, None]
    start = torch.maximum(t1, nowb)
    feasible = valid & (start + durb <= torch.minimum(t2, deadline))
    key = torch.where(feasible, start, STATE_BIG).reshape(t1.shape[0], -1)
    best = key.amin(1)
    return best < STATE_BIG, best


def _fleet_windows(seed, B=64):
    """Fleet-shaped windows [B, 4, 3, 2, 16] with invalid slots at the
    engine's BIG, ``now`` per replica (some past every window, so that
    nothing is found) and the HP durations."""
    rng = np.random.default_rng(seed)
    t1, t2, valid = _windows(rng, (B, 4, 3), 2, 16)
    t1 = np.where(valid, t1, np.float32(STATE_BIG)).astype(np.float32)
    t2 = np.where(valid, t2, np.float32(STATE_BIG)).astype(np.float32)
    now = rng.uniform(0, 120, B).astype(np.float32)
    dur = rng.choice(np.float32([0.3, 1.7, 3.1]), B).astype(np.float32)
    # ties: an HP window ending exactly at max(t1, now) + dur
    edge = np.maximum(t1[:, :, 0], now[:, None, None, None]) + dur[:, None,
                                                                    None, None]
    pick = rng.random(edge.shape) < 0.2
    t2[:, :, 0] = np.where(pick & valid[:, :, 0], edge, t2[:, :, 0])
    return t1, t2, valid, now, dur


@pytest.mark.parametrize("seed", range(3))
def test_hp_query_matches_the_reference_and_the_inline_form(seed):
    t1, t2, valid, now, dur = _fleet_windows(seed)
    B = now.shape[0]
    hp_deadline = 3.0
    # the deadline as the reference builds it: now + max(hp, dur + 1e-6)
    dl = now + np.maximum(np.float32(hp_deadline), dur + np.float32(1e-6))
    min_dur = np.zeros((B, 3), np.float32)
    st_t = SchedState(*_t(t1, t2, valid, min_dur), *[None] * 4)
    st_j = type("S", (), {"win_t1": jnp.asarray(t1),
                          "win_t2": jnp.asarray(t2),
                          "win_valid": jnp.asarray(valid)})
    n_found = 0
    for d in range(4):
        found_j, start_j = hp_query_j(st_j, d, jnp.asarray(now),
                                      jnp.asarray(dur), hp_deadline)
        found_j, start_j = np.asarray(found_j), np.asarray(start_j)
        found, start = engine_t._hp_query(st_t, d, *_t(now, dur, dl))
        inl_found, inl_start = _hp_query_inline(st_t, d, *_t(now, dur, dl))
        assert found.dtype == torch.bool
        np.testing.assert_array_equal(found.numpy(), found_j)
        np.testing.assert_array_equal(inl_found.numpy(), found_j)
        # start is read only where found: there it is equal bit for bit ...
        np.testing.assert_array_equal(_bits(start.numpy()[found_j]),
                                      _bits(start_j[found_j]))
        np.testing.assert_array_equal(_bits(inl_start.numpy()[found_j]),
                                      _bits(start_j[found_j]))
        # ... and elsewhere each carries its own sentinel
        assert (start.numpy()[~found_j] == np.float32(BIG)).all()
        assert (start_j[~found_j] == np.float32(STATE_BIG)).all()
        n_found += found_j.sum()
    assert 0 < n_found < 4 * B


def test_hp_query_backend_follows_the_fleet_params():
    t1, t2, valid, now, dur = _fleet_windows(7, B=5)
    st = SchedState(*_t(t1, t2, valid), None, *[None] * 4)
    with pytest.raises(ValueError, match="CUDA"):
        engine_t._hp_query(st, 0, *_t(now, dur, now + 3), "kernel")
    found, _ = engine_t._hp_query(st, 0, *_t(now, dur, now + 3), "ref")
    assert found.shape == (5,)
