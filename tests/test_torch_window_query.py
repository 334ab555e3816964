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
from repro_torch.kernels import _build
from repro_torch.kernels.window_query import ops as ops_mod
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
    """One block a tile of ``rows_per_block(T·W)`` rows, the last ragged:
    ``WARPS`` warps of 32 / G rows, G lanes a row."""
    groups = {1: 1, 4: 1, 8: 2, 15: 4, 32: 8, 48: 16, 128: 32, 192: 32}
    for tw, group in groups.items():
        assert wq_mod.group_size(tw) == group
        tile = wq_mod.rows_per_block(tw)
        assert tile == wq_mod.WARPS * (32 // group)
        for rows in (1, 7, 8, 9, 300, 8192 * 4, 262_144):
            (blocks,) = wq_mod.launch_grid(rows, tw)
            assert (blocks - 1) * tile < rows <= blocks * tile


def test_param_passes_a_ready_column_and_broadcasts_the_rest():
    """The dispatcher hands an f32 [B, Dev] parameter on the windows' device
    to the wrapper as it is (the fleet's [B, 1] columns) and broadcasts
    anything else, as the JAX package's ``broadcast_to`` does."""
    cpu = torch.device("cpu")
    col = torch.rand(5, 1)
    assert ops_mod._param(col, (5, 1), cpu) is col
    x = ops_mod._param(3.5, (5, 4), cpu)
    assert x.shape == (5, 4) and x.dtype == torch.float32
    assert x.stride() == (0, 0) and (x == 3.5).all()
    wide = torch.rand(5, 1, dtype=torch.float64)
    y = ops_mod._param(wide, (5, 1), cpu)
    assert y.dtype == torch.float32 and torch.equal(y, wide.float())
    z = ops_mod._param(col[:, 0][:4], (5, 4), cpu)
    assert z.shape == (5, 4) and torch.equal(z[3], col[:4, 0])


# ---------------------------------------------------------------------------
# the kernel's design: routes, tiling and lane groups
# ---------------------------------------------------------------------------

def _fleet_view():
    """The fleet's HP view of device 1: [B, 1, T, W] slices of
    [B, 4, 3, 2, 16] windows, as ``_hp_query`` passes them."""
    t1 = torch.zeros(64, 4, 3, 2, 16)
    valid = torch.zeros(t1.shape, dtype=torch.bool)
    return t1[:, 1:2, 0], t1[:, 1:2, 0], valid[:, 1:2, 0]


def _contiguous(*shape):
    return (torch.empty(shape), torch.empty(shape),
            torch.empty(shape, dtype=torch.bool))


def _offset(shape, by=(1, 1, 1)):
    """Windows ``by`` elements into flat buffers (per tensor)."""
    n = int(np.prod(shape))
    return tuple(torch.empty(n + k, dtype=dt)[k:].view(shape)
                 for k, dt in zip(by, (torch.float32, torch.float32,
                                       torch.bool)))


def _row_stride(step):
    """Rows ``step`` elements apart."""
    return tuple(torch.empty(64 * step, dtype=dt).as_strided((64, 2, 16),
                                                             (step, 16, 1))
                 for dt in (torch.float32, torch.float32, torch.bool))


@pytest.mark.parametrize("make,want", [
    (_fleet_view, "vec"),
    (lambda: _contiguous(262_144, 2, 16), "vec"),
    (lambda: _contiguous(1024, 2, 64), "vec"),
    (lambda: _contiguous(8, 4, 3, 16), "vec"),
    (lambda: _offset((2048, 4, 2, 16)), "scalar"),
    (lambda: _offset((64, 2, 16), by=(0, 0, 1)), "scalar"),
    (lambda: _offset((64, 2, 16), by=(0, 4, 4)), "vec"),
    (lambda: _contiguous(4096, 1, 15), "scalar"),
    (lambda: _row_stride(33), "scalar"),
    (lambda: _row_stride(34), "scalar"),
    (lambda: _row_stride(36), "vec"),
], ids=["fleet-hp-view", "262144x2x16", "1024x2x64", "8x4x3x16",
        "offset-by-one", "valid-offset-by-one", "offset-by-16-bytes",
        "w15", "odd-outer-stride", "outer-stride-2-mod-4",
        "outer-stride-4-mod-4"])
def test_route_helper(make, want):
    """The vector route exactly where every row start of t1 and t2 is
    16-byte aligned and of valid 4-byte aligned, and T·W % 4 == 0; CPU
    tensors are 64-byte aligned, as CUDA ones are."""
    assert wq_mod.route(*make()) == want


def _kernel_model(t1, t2, valid, q1, dl, dur, route):
    """The CUDA kernel over [rows, T·W] windows and [rows] parameters,
    block by block and thread by thread: ``launch_grid``'s blocks of
    ``WARPS`` warps, G = ``group_size(T·W)`` lanes a row, lane g of a group
    over chunks g, g + G, ... of 4 windows (on the scalar route a window
    past T·W loads as not valid), the chunk's min, then a butterfly of
    xor-shuffles inside the group; lane 0 of a live group stores. Checks
    that every row is stored exactly once and that the vector route never
    reads past a row."""
    rows, tw = t1.shape
    G = wq_mod.group_size(tw)
    rpw, n_chunks = 32 // G, -(-tw // 4)
    step = wq_mod.WARPS * rpw
    thread = torch.arange(wq_mod.WARPS * 32)
    lane, warp = thread % 32, thread // 32
    g = lane % G
    big = torch.tensor(BIG, dtype=torch.float32)
    start = torch.full((rows,), float("nan"))
    found = torch.full((rows,), -1, dtype=torch.int32)
    stores = torch.zeros(rows, dtype=torch.long)
    (grid,) = wq_mod.launch_grid(rows, tw)
    for blk in range(grid):
        row = blk * step + warp * rpw + lane // G
        live = row < rows
        r = torch.where(live, row, rows - 1)[:, None]
        best = torch.full((thread.numel(),), float("inf"))
        for c0 in range(0, n_chunks, G):
            c = c0 + g
            load = live & (c < n_chunks)
            idx = 4 * c[:, None] + torch.arange(4)
            inside = idx < tw
            if route == "vec":
                assert inside[load].all()
            idx = idx.clamp(max=tw - 1)
            s = torch.maximum(t1[r, idx], q1[r])
            ok = (valid[r, idx] & inside
                  & (s + dur[r] <= torch.minimum(t2[r, idx], dl[r])))
            chunk = torch.where(ok, s, big).amin(1)
            best = torch.where(load, torch.minimum(best, chunk), best)
        off = G // 2
        while off:
            best = torch.minimum(best, best.view(-1, 32)[
                :, torch.arange(32) ^ off].reshape(-1))
            off //= 2
        store = live & (g == 0)
        start[row[store]] = best[store]
        found[row[store]] = (best[store] < big).to(torch.int32)
        stores.index_add_(0, row[store], torch.ones_like(row[store]))
    assert (stores == 1).all()
    return found, start


#: (rows, T, W, route): the fleet's list, T 1 x W 15, spare lanes (T 3 x
#: W 16: 12 chunks on 16 lanes), two chunks a lane (T 3 x W 64), a lane a
#: row (T 1 x W 1 and W 4), bench_query's T 2 x W 64 and a ragged tile
DESIGN = [(300, 2, 16, "vec"), (77, 1, 15, "scalar"), (41, 3, 16, "vec"),
          (21, 3, 64, "vec"), (300, 1, 1, "scalar"), (70, 1, 4, "vec"),
          (130, 2, 64, "vec"), (18, 2, 16, "scalar")]


@pytest.mark.parametrize("rows,T,W,route", DESIGN)
def test_kernel_model_matches_the_plain_version(rows, T, W, route):
    """The kernel's tiling, lane groups and routes, modelled lane by lane,
    give the plain version's (and the JAX oracle's) answer bit for bit, ties
    on the ``<=`` included."""
    rng = np.random.default_rng(rows * 100 + T * 10 + W)
    t1, t2, valid = _windows(rng, (rows,), T, W)
    q1 = rng.uniform(0, 60, rows).astype(np.float32)
    dl = q1 + rng.uniform(10, 80, rows).astype(np.float32)
    dur = rng.uniform(1, 30, rows).astype(np.float32)
    t2, _ = _tie(t1, t2, valid, rng, q1[:, None, None], dur[:, None, None])
    flat = [x.reshape(rows, -1) for x in _t(t1, t2, valid)]
    got = _kernel_model(*flat, *_t(q1, dl, dur), route)
    want = window_query_batched_ref(*_t(t1[:, None], t2[:, None],
                                        valid[:, None], q1[:, None],
                                        dl[:, None], dur[:, None]))
    _assert_bits([got[0][:, None], got[1][:, None]], want)
    jx = [jnp.asarray(x) for x in (t1[:, None], t2[:, None], valid[:, None],
                                   q1[:, None], dl[:, None], dur[:, None])]
    _assert_bits(want, wqb_j(*jx))
    assert 0 < int(got[0].sum()) <= rows


# ---------------------------------------------------------------------------
# the wrapper's argument check (``_build.check_strided``)
# ---------------------------------------------------------------------------

@pytest.fixture
def no_device_check(monkeypatch):
    """``check_strided`` with its device, dtype and shape check stubbed, so
    that its stride and storage checks run on the host."""
    monkeypatch.setattr(_build, "_check_meta", lambda *args: None)


class _Fake:
    """A tensor's metadata whose strides reach past its storage, which no
    torch view can be: ``as_strided`` refuses one."""

    def __init__(self, shape, strides, offset, storage_elems):
        self.shape, self._strides = torch.Size(shape), strides
        self._offset, self._bytes = offset, 4 * storage_elems

    def stride(self):
        return self._strides

    def storage_offset(self):
        return self._offset

    def element_size(self):
        return 4

    def untyped_storage(self):
        return type("S", (), {"nbytes": lambda _: self._bytes})()


@pytest.mark.parametrize("make,inner", [
    (lambda: torch.zeros(6, 4, 3, 2, 16), 2),
    (lambda: torch.zeros(6, 4, 3, 2, 16)[:, 1:2, 0], 2),
    (lambda: torch.zeros(6, 4, 3, 2, 16)[2:5, :, 2], 2),
    (lambda: torch.zeros(0, 2, 16), 2),
    (lambda: torch.zeros(5, 3)[:, :1], 0),
    (lambda: torch.tensor(2.0).expand(5, 1), 0),
    (lambda: torch.zeros(5, 1, 2, 16).transpose(0, 1), 2),
], ids=["contiguous", "fleet-hp-view", "strided-rows", "empty",
        "column", "broadcast", "size-1-dim"])
def test_check_strided_takes_views_inside_their_storage(no_device_check,
                                                        make, inner):
    x = make()
    _build.check_strided("k", "x", x, x.dtype, tuple(x.shape), x.device,
                         inner=inner)


@pytest.mark.parametrize("make,inner,match", [
    (lambda: torch.zeros(4, 16, 2).transpose(1, 2), 2, "contiguous"),
    (lambda: torch.zeros(4, 2, 32)[..., :16], 2, "contiguous"),
    (lambda: _Fake((4, 2, 16), (32, 16, 1), 0, 127), 2, "storage"),
    (lambda: _Fake((4, 2, 16), (32, 16, 1), 1, 128), 2, "storage"),
    (lambda: _Fake((5, 1), (3, 1), 3, 15), 0, "storage"),
], ids=["inner-transposed", "inner-cut", "last-element-past",
        "offset-past", "column-past"])
def test_check_strided_refuses(no_device_check, make, inner, match):
    x = make()
    with pytest.raises(ValueError, match=match):
        _build.check_strided("k", "x", x, None, tuple(x.shape), None,
                             inner=inner)


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
