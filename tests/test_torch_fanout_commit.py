"""The port's HP fan-out commit (``kernels/placement/ops.py::
fanout_commit_op``) on the host: its plain route is
``core/tensor_state.fanout_commit`` bit for bit, on seeded random rows and
on hand-built HP rows (``cases.HP_ROWS``) committed on every device, and
both hold to the JAX package's ``jax_state.fanout_commit``; the backend
policy sends CPU tensors to the plain version and refuses the kernel; the
wrapper's ctypes types follow the C entry point; the plain route counts
the rows committed and the rows whose windows changed.

Tolerance is exact equality, compared bit for bit: the commit is f32
compare, min, max, select and in-order adds. The CUDA kernel itself runs
only on the card; ``chip_smoke.py`` holds it to this plain version, bit
for bit.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_state
from repro_torch.core import tensor_state
from repro_torch.kernels import _build
from repro_torch.kernels.placement import cases
from repro_torch.kernels.placement import placement as placement_t
from repro_torch.kernels.placement.ops import fanout_commit_op

HP = cases.HP
OUTPUTS = ("t1", "t2", "valid", "n_dropped", "time_dropped")


def _t(case):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in case]


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_same(want, got, names=OUTPUTS):
    for name, w, g in zip(names, want, got):
        w, g = np.asarray(w), np.asarray(g)
        assert w.dtype == g.dtype, name
        np.testing.assert_array_equal(_bits(w), _bits(g), err_msg=name)


def _plain(case, dev, cfg=HP):
    """``tensor_state.fanout_commit`` with ``dev`` and ``cfg`` on every
    row: its five outputs."""
    t1, t2, valid, md, s, e, do = _t(case)
    n = s.shape[0]
    full = lambda x: torch.full((n,), x, dtype=torch.int32)
    return tensor_state.fanout_commit(t1, t2, valid, md, full(dev),
                                      full(cfg), s, e, do)


def _op(case, dev, backend, cfg=HP, counts=None):
    t1, t2, valid, md, s, e, do = _t(case)
    return fanout_commit_op(t1, t2, valid, md, dev, cfg, s, e, do,
                            backend=backend, counts=counts)


def _case(name, dev):
    if name == "adversarial":
        return cases.hp_adversarial_case(dev)
    if name == "adversarial-in-random":
        return cases.with_hp_adversarial_rows(
            cases.random_hp_case(13, seed=4), dev)
    b, seed = {"random-1": (1, 0), "random-5": (5, 1),
               "random-13": (13, 2), "random-37": (37, 3)}[name]
    return cases.random_hp_case(b, seed=seed)


CASES = ("adversarial", "adversarial-in-random", "random-1", "random-5",
         "random-13", "random-37")


@pytest.mark.parametrize("backend", ["auto", "ref"])
@pytest.mark.parametrize("dev", range(cases.DEV))
@pytest.mark.parametrize("name", CASES)
def test_op_on_cpu_is_the_plain_version_bit_for_bit(name, dev, backend):
    case = _case(name, dev)
    want = _plain(case, dev)
    got = _op(case, dev, backend)
    assert len(got) == 4
    _assert_same(want[:4], got)


@pytest.mark.parametrize("cfg", [HP, cases.LP2, cases.LP4])
def test_op_commits_any_task_config(cfg):
    """The same rows committed for a task of each config (the fleet
    commits HP tasks; the kernel takes the config as an argument)."""
    case = cases.random_hp_case(13, seed=7, do_rate=1.0)
    _assert_same(_plain(case, 2, cfg)[:4], _op(case, 2, "ref", cfg))


@pytest.mark.parametrize("kernel_safe", [False, True])
@pytest.mark.parametrize("dev", range(cases.DEV))
@pytest.mark.parametrize("name", CASES)
def test_plain_version_matches_jax_fanout_commit(name, dev, kernel_safe):
    case = _case(name, dev)
    t1, t2, valid, md, s, e, do = case
    n = len(s)
    want = jax_state.fanout_commit(
        jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(valid),
        jnp.asarray(md), jnp.full((n,), dev, jnp.int32),
        jnp.full((n,), HP, jnp.int32), jnp.asarray(s), jnp.asarray(e),
        jnp.asarray(do), kernel_safe=kernel_safe)
    _assert_same(want, _plain(case, dev))
    _assert_same(want[:4], _op(case, dev, "auto"))


_EXPECT = {
    # row: (n_dropped, windows changed)
    "do_false": (0, False),
    "equal_overlap": (0, True),
    "straddle_no_slot": (3, True),
    "overlap_sum_order": (0, True),
    "stale_invalid": (0, True),
    "preempt_no_overlap": (0, False),
}


@pytest.mark.parametrize("row", cases.HP_ROWS)
def test_hp_row_semantics(row):
    """Each hand-built HP row does what its name says, on device 1; no
    other device's windows move."""
    dev = 1
    case = cases.hp_adversarial_case(dev)
    i = cases.HP_ROWS.index(row)
    nt1, nt2, nv, n_drop = _op(case, dev, "ref")
    t1, t2, valid = (torch.from_numpy(x[i]) for x in case[:3])
    changed = not (torch.equal(nt1[i], t1) and torch.equal(nt2[i], t2)
                   and torch.equal(nv[i], valid))
    assert (int(n_drop[i]), changed) == _EXPECT[row]
    others = [d for d in range(cases.DEV) if d != dev]
    assert torch.equal(nt1[i, others], t1[others])
    assert torch.equal(nv[i, others], valid[others])
    if row == "do_false":
        assert nt1[i, dev, HP, 1, 2] == 40.0 and not nv[i, dev, HP, 1, 2]
    if row == "equal_overlap":
        # the tie goes to track 0: its first two windows are gone and the
        # third keeps its right piece; track 1 keeps both of its own
        assert nv[i, dev, HP, 0].tolist()[:3] == [False, False, True]
        assert nt1[i, dev, HP, 0, 2] == 16.0
        assert nv[i, dev, HP, 1, :2].all()
    if row == "overlap_sum_order":
        s, e = case[4][i], case[5][i]
        tt1, tt2, vv = t1[dev, HP], t2[dev, HP], valid[dev, HP]
        part = torch.where(vv & (tt1 < e) & (s < tt2),
                           torch.minimum(tt2, torch.tensor(e))
                           - torch.maximum(tt1, torch.tensor(s)), 0.0)
        x0, x1, x2 = part[0, :3]
        assert (0.0 + x0 + x1) + x2 == part[1, 0] != (x0 + x2) + x1
        assert not nv[i, dev, HP, 0].any()
        assert nv[i, dev, HP, 1, 0]
    if row == "stale_invalid":
        # the stale slots of the committed device come back as BIG, the
        # other device's stale slot is left as it was
        big = np.float32(tensor_state.BIG)
        for c, t, w in [(HP, 1, 2), (HP, 1, 3), (HP, 1, 4), (cases.LP4, 1, 0)]:
            assert not nv[i, dev, c, t, w]
            assert nt1[i, dev, c, t, w] == nt2[i, dev, c, t, w] == big
        assert nt1[i, (dev + 1) % cases.DEV, HP, 1, 3] == 40.0


def test_plain_route_leaves_inputs_untouched():
    tens = _t(cases.with_hp_adversarial_rows(
        cases.random_hp_case(16, seed=2, do_rate=1.0), 2))
    before = [x.clone() for x in tens]
    t1, t2, valid, md, s, e, do = tens
    out = fanout_commit_op(t1, t2, valid, md, 2, HP, s, e, do,
                           backend="ref")
    assert not torch.equal(out[0], t1)
    for a, b in zip(tens, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["adversarial", "random-37"])
def test_plain_route_counts_rows_committed_and_changed(name):
    """``counts`` gets the rows committed (``do``) and the rows whose
    windows changed added to it; the outputs are the uncounted call's."""
    case = _case(name, 3)
    want = _op(case, 3, "ref")
    counts = torch.tensor([5, 2])
    got = _op(case, 3, "ref", counts=counts)
    _assert_same(want, got)
    t1, t2, valid = _t(case[:3])
    changed = sum(
        not (torch.equal(want[0][i], t1[i]) and torch.equal(want[1][i], t2[i])
             and torch.equal(want[2][i], valid[i]))
        for i in range(len(t1)))
    assert counts.tolist() == [5 + int(case[6].sum()), 2 + changed]
    if name == "adversarial":
        assert changed == 4 and int(case[6].sum()) == 5


def test_kernel_backend_refuses_cpu_tensors():
    case = cases.random_hp_case(5, seed=6)
    launches = placement_t.launches_fanout_commit
    with pytest.raises(ValueError, match="CUDA"):
        _op(case, 0, "kernel")
    with pytest.raises(ValueError, match="CUDA"):
        placement_t.fanout_commit(*_t(case[:4]), 0, HP, *_t(case[4:]))
    assert placement_t.launches_fanout_commit == launches


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        _op(cases.random_hp_case(2, seed=1), 0, "tpu")


def test_ctypes_signature_matches_the_c_entry_point():
    """The wrapper declares one ctypes type per parameter of
    ``fanout_commit_launch``, in order, in the library ``fused_place``
    lives in."""
    src = _build._sources("placement")[0].read_text()
    params = re.search(r"int fanout_commit_launch\(([^)]*)\)",
                       src).group(1)
    kinds = []
    for decl in params.split(","):
        decl = decl.strip()
        kinds.append("p" if "*" in decl else decl.split()[0])
    want = {"p": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}
    assert [want[k] for k in kinds] == placement_t._FANOUT_ARGTYPES


def test_kernel_is_built_for_the_wrappers_shapes():
    """The fan-out kernel is instantiated for exactly the (T, W) shapes the
    wrapper accepts, in the placement library, and its entry point checks
    the wrapper's grid."""
    src = _build._sources("placement")[0].read_text()
    built = {tuple(map(int, m)) for m in re.findall(
        r"launch_fanout<(\d+), (\d+)>\(FC_ARGS\)", src)}
    assert built == placement_t._SHAPES_BUILT
    body = src[src.index("int fanout_commit_launch("):]
    body = body[:body.index("\n}\n")]
    assert "int grid_x" in body and "return -2;" in body
