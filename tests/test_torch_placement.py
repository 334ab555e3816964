"""The port's fused placement against the JAX package: the plain PyTorch
version reproduces ``repro``'s jnp oracle and its Pallas kernel (run in
interpret mode on the host) on seeded random rows and on hand-built rows
that each drive one corner of the selection and commit; and the backend
policy sends CPU tensors to the plain version and refuses the kernel.

Tolerance is exact equality: the placement is f32 compare, min, max,
select and add with first-index tie-breaks, so 0 ULP is reachable. The
CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it to
this plain version, bit for bit.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.placement.placement import fused_place as fused_place_pallas
from repro.kernels.placement.ref import SRC_PREF as SRC_PREF_J
from repro.kernels.placement.ref import fused_place_ref as fused_place_j
from repro_torch.kernels import _build
from repro_torch.kernels.placement import cases
from repro_torch.kernels.placement import placement as placement_t
from repro_torch.kernels.placement.ops import fused_place_op
from repro_torch.kernels.placement.ref import SRC_PREF, fused_place_ref

OUTPUTS = ("t1", "t2", "valid", "ok", "sel", "start", "dur", "use4",
           "n_dropped")


def _t(case):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in case]


def _assert_same(ref, got):
    for name, r, g in zip(OUTPUTS, ref, got):
        r = np.asarray(r)
        assert r.dtype == g.numpy().dtype, name
        np.testing.assert_array_equal(r, g.numpy(), err_msg=name)


def test_src_pref_matches():
    assert SRC_PREF == SRC_PREF_J


@pytest.mark.parametrize("b", [1, 5, 8, 13])
def test_ref_matches_jax_oracle_and_pallas_kernel(b):
    for seed in range(3):
        case = cases.random_case(b, seed=seed)
        got = fused_place_ref(*_t(case))
        _assert_same(fused_place_j(*case), got)
        _assert_same(fused_place_pallas(*case, interpret=True), got)


def test_adversarial_rows_match_jax_oracle_and_pallas_kernel():
    case = cases.adversarial_case()
    got = fused_place_ref(*_t(case))
    _assert_same(fused_place_j(*case), got)
    _assert_same(fused_place_pallas(*case, interpret=True), got)


def test_adversarial_rows_inside_random_batch_match():
    case = cases.with_adversarial_rows(cases.random_case(13, seed=4))
    _assert_same(fused_place_j(*case), fused_place_ref(*_t(case)))


_EXPECT = {
    # row: (ok, sel, use4, n_dropped)
    "do_false": (False, 1, False, 0),
    "equal_starts": (True, 0, False, 0),
    "src_pref_wins": (True, 2, False, 0),
    "src_pref_loses": (True, 0, False, 0),
    "lp4_fallback": (True, 3, True, 0),
    "equal_overlap": (True, 0, False, 0),
    "straddle_no_slot": (True, 0, False, 3),
    "overlap_sum_order": (True, 0, False, 0),
}


@pytest.mark.parametrize("row", cases.ADVERSARIAL_ROWS)
def test_adversarial_row_semantics(row):
    """Each hand-built row does what its name says."""
    case = cases.adversarial_case()
    i = cases.ADVERSARIAL_ROWS.index(row)
    nt1, nt2, nv, ok, sel, start, dur, use4, n_drop = fused_place_ref(
        *_t(case))
    assert (bool(ok[i]), int(sel[i]), bool(use4[i]), int(n_drop[i])) == (
        _EXPECT[row])
    if row == "do_false":
        assert torch.equal(nt1[i], torch.from_numpy(case[0][i]))
        assert torch.equal(nv[i], torch.from_numpy(case[2][i]))
    if row == "equal_overlap":
        # the hp list's first track lost all three windows, the second
        # kept both of its own
        assert not nv[i, 0, 0, 0].any()
        assert nv[i, 0, 0, 1, :2].all()
    if row == "overlap_sum_order":
        # track 0's overlaps tie track 1's summed in order, not as a tree;
        # the tie goes to track 0, which lost its three windows
        t1, t2, valid = (torch.from_numpy(x[i, 0, 0]) for x in case[:3])
        s, e = start[i], start[i] + dur[i]
        part = torch.where(valid & (t1 < e) & (s < t2),
                           torch.minimum(t2, e) - torch.maximum(t1, s), 0.0)
        x0, x1, x2 = part[0, :3]
        assert (0.0 + x0 + x1) + x2 == part[1, 0] != (x0 + x2) + x1
        assert not nv[i, 0, 0, 0].any()
        assert nv[i, 0, 0, 1, 0] and not nv[i, 0, 0, 1, 1:].any()


@pytest.mark.parametrize("b", [1, 13])
def test_plain_route_counts_rows_attempted_and_committed(b):
    """``counts`` gets the rows attempted and committed added to it; the
    outputs are the uncounted call's."""
    case = cases.random_case(b, seed=4)
    want = fused_place_ref(*_t(case))
    counts = torch.tensor([5, 2])
    got = fused_place_op(*_t(case), backend="ref", counts=counts)
    _assert_same(want, got)
    assert counts.tolist() == [5 + int(case[7].sum()),
                               2 + int(want[3].sum())]


def test_ref_leaves_inputs_untouched():
    tens = _t(cases.random_case(8, seed=2, do_rate=1.0))
    before = [x.clone() for x in tens]
    out = fused_place_ref(*tens)
    assert out[3].any()
    for a, b in zip(tens, before):
        assert torch.equal(a, b)


def test_auto_backend_on_cpu_is_the_plain_version():
    tens = _t(cases.random_case(5, seed=6))
    for r, g in zip(fused_place_ref(*tens),
                    fused_place_op(*tens, backend="auto")):
        assert torch.equal(r, g)


def test_kernel_backend_refuses_cpu_tensors():
    tens = _t(cases.random_case(5, seed=6))
    launches = placement_t.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_place_op(*tens, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        placement_t.fused_place(*tens)
    assert placement_t.launches == launches


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        fused_place_op(*_t(cases.random_case(2, seed=1)), backend="tpu")


def test_kernel_build_recipe():
    """The kernel builds from the package's own source for sm_90a, without
    fast math and without multiply-add contraction, and the wrapper
    accepts exactly the (T, W) shapes the source instantiates."""
    srcs = _build._sources("placement")
    assert [p.name for p in srcs] == ["placement.cu"]
    assert srcs[0].is_relative_to(Path(_build.__file__).parent)
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags and "fast_math" not in flags
    built = {tuple(map(int, m)) for m in re.findall(
        r"launch<(\d+), (\d+)>\(FP_ARGS\)", srcs[0].read_text())}
    assert built == placement_t._SHAPES_BUILT
    assert _build._lib_path("placement").parent == _build.BUILD_DIR


def test_ctypes_signature_matches_the_c_entry_point():
    """The wrapper declares one ctypes type per parameter of
    ``fused_place_launch``, in order (ctypes would otherwise pass a
    pointer as a 32-bit int, or refuse the call on the card)."""
    src = _build._sources("placement")[0].read_text()
    params = re.search(r"int fused_place_launch\(([^)]*)\)", src).group(1)
    kinds = []
    for decl in params.split(","):
        decl = decl.strip()
        kinds.append("p" if "*" in decl else decl.split()[0])
    want = {"p": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}
    assert [want[k] for k in kinds] == placement_t._ARGTYPES


def test_occ_bits_encode_the_table():
    from repro_torch.core.tensor_state import OCC_TABLE

    for ti in range(3):
        for li in range(3):
            got = (placement_t._OCC_BITS >> (3 * (ti * 3 + li))) & 7
            assert got == OCC_TABLE[ti, li]
