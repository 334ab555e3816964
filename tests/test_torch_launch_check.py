"""The port's launch geometry checker, case for case against the JAX
package's ``tests/test_analysis_geometry.py``: the registry covers every
kernel package of the port that has CUDA sources and reports it clean;
each seeded fixture trips its violation class; a reduction axis, a masked
dim and the alias tiling rule behave as in the reference; a rank mismatch
is reported; the grid cap holds; and the copy of the checker reports what
the reference's reports, on the reference's own fixtures and production
geometry. The racy fixture's plain version shows the corruption the race
predicts (the CUDA kernel itself runs in ``chip_smoke.py``).

Also the link between each declaration and its launch: every wrapper's
``launch_grid`` tiles by the block size its ``.cu`` file declares, and the
C entry points take the grid the wrappers pass.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import pallas_check as pallas_check_j
from repro.analysis.fixtures.racy_kernel import (
    GEOMETRY_PROVIDERS as PROVIDERS_J, racy_sum as racy_sum_j,
)
from repro_torch.analysis import cli
from repro_torch.analysis.fixtures import racy_kernel
from repro_torch.analysis.fixtures.racy_kernel import (
    GEOMETRY_PROVIDERS, racy_sum, racy_sum_oracle, racy_sum_ref,
)
from repro_torch.analysis.launch_check import (
    BlockDecl, KernelGeometry, MAX_GRID_POINTS, check_all, check_geometry,
    load_registry,
)
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa_t
from repro_torch.kernels.flash_decode import flash_decode as fd_t
from repro_torch.kernels.placement import placement as placement_t
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_t
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_t
from repro_torch.kernels.window_query import window_query as wq_t

PORT_KERNELS = {
    "flash_attention", "flash_decode", "placement",
    "ssd_scan", "ssm_scan", "window_query",
}


def _kernel_packages():
    """Every kernel package of the port that has CUDA sources."""
    return {p.parent.name for p in _build.KERNELS_DIR.glob("*/csrc")}


def test_registry_covers_every_kernel_package_with_cuda_sources():
    assert _kernel_packages() == PORT_KERNELS
    assert _kernel_packages() <= set(load_registry())


def test_production_registry_declares_every_launch_of_the_redesign():
    """The bf16 and f32 attention routes each have declared launches, and
    decode declares both its passes at every case."""
    report = check_all()
    assert report["ok"]
    reg = load_registry()
    fa_cases = [g.case for g in reg["flash_attention"]()]
    assert any(c.startswith("wgmma-") for c in fa_cases)
    assert any(c.startswith("simt-") for c in fa_cases)
    fd_cases = [g.case for g in reg["flash_decode"]()]
    splits = {c[len("split-"):] for c in fd_cases if c.startswith("split-")}
    combines = {c[len("combine-"):] for c in fd_cases
                if c.startswith("combine-")}
    assert splits and splits == combines


def test_production_geometry_is_clean():
    report = check_all()
    assert report["ok"], report["violations"]
    assert report["n_kernels"] >= len(PORT_KERNELS)
    for name, entry in report["kernels"].items():
        assert entry["grid_points_checked"] > 0, name
        assert entry["cases"], name


@pytest.mark.parametrize("fixture,kind", [
    ("race", "write-race"),
    ("oob", "oob"),
    ("alias", "alias"),
])
def test_fixture_trips_expected_violation(fixture, kind):
    violations = []
    for g in GEOMETRY_PROVIDERS[fixture]():
        violations.extend(check_geometry(g))
    assert violations, f"fixture {fixture} produced no violation"
    assert {v.kind for v in violations} == {kind}


def test_fixture_report_fails_via_check_all():
    report = check_all({"fixture_race": GEOMETRY_PROVIDERS["race"]})
    assert not report["ok"]
    assert report["n_violations"] == 1
    assert report["kernels"]["fixture_race"]["violations"]


def test_racy_kernel_plain_version_shows_the_corruption():
    """The racy launch with its grid run in order, as the JAX package runs
    it in interpret mode: the last block wins every output, and half of the
    input is lost against a correct reduction."""
    x = np.arange(8, dtype=np.float32)
    got = racy_sum_ref(torch.from_numpy(x))
    want = racy_sum_oracle(torch.from_numpy(x))
    assert not torch.allclose(got, want), "race did not manifest"
    np.testing.assert_array_equal(got.numpy(), x[4:] * 2.0)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(racy_sum_j(jnp.asarray(x))))
    np.testing.assert_array_equal(
        want.numpy(), x[:4] * 1.0 + x[4:] * 2.0)


def test_racy_kernel_runs_on_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA"):
        racy_sum(torch.arange(8, dtype=torch.float32))


def test_race_geometry_is_the_launch_of_racy_sum():
    (g,) = racy_kernel.race_geometry(n=4)
    assert g.grid == racy_kernel.GRID == (2,)
    assert _build._sources("racy_sum") == [
        Path(racy_kernel.__file__).parent / "csrc" / "racy_sum.cu"]
    assert not (_build.KERNELS_DIR / "racy_sum").exists()


def test_reduction_axis_admits_shared_output_block():
    """A sequential accumulation axis (flash-attention style) must NOT be
    reported as a race when declared — and must be when not."""
    def geom(red):
        return KernelGeometry(
            kernel="k", module="m", case="c", grid=(2, 3),
            inputs=(),
            outputs=(BlockDecl("o", (2, 8), (1, 8),
                               lambda i, k: (i, 0)),),
            reduction_axes=frozenset({1} if red else ()),
        )
    assert check_geometry(geom(red=True)) == []
    bad = check_geometry(geom(red=False))
    assert bad and bad[0].kind == "write-race"


def test_masked_dim_admits_ragged_edge():
    def geom(masked):
        decl = BlockDecl("o", (10,), (4,), lambda i: (i,),
                         masked_dims=frozenset({0} if masked else ()))
        return KernelGeometry(kernel="k", module="m", case="c",
                              grid=(3,), inputs=(), outputs=(decl,))
    assert check_geometry(geom(masked=True)) == []
    bad = check_geometry(geom(masked=False))
    assert bad and bad[0].kind == "oob"


def test_declared_alias_must_tile_identically():
    win = lambda im: BlockDecl("w", (8,), (4,), im, buffer="b")
    g = KernelGeometry(
        kernel="k", module="m", case="c", grid=(2,),
        inputs=(win(lambda i: (i,)),),
        outputs=(win(lambda i: (1 - i,)),),       # disagreeing map
        aliases={0: 0},
    )
    bad = check_geometry(g)
    assert bad and bad[0].kind == "alias"


def test_spec_rank_mismatch_reported():
    g = KernelGeometry(
        kernel="k", module="m", case="c", grid=(1,),
        inputs=(BlockDecl("x", (4, 4), (4,), lambda i: (i,)),),
        outputs=(),
    )
    bad = check_geometry(g)
    assert bad and bad[0].kind == "spec"


def test_grid_enumeration_is_capped():
    g = KernelGeometry(
        kernel="k", module="m", case="c",
        grid=(MAX_GRID_POINTS + 1,),
        inputs=(),
        outputs=(BlockDecl("o", (4,), (4,), lambda i: (0,)),),
    )
    with pytest.raises(ValueError, match="MAX_GRID_POINTS"):
        check_geometry(g)


# ---------------------------------------------------------------------------
# the copy is pinned to the reference
# ---------------------------------------------------------------------------

def _as_tuples(violations):
    return sorted((v.kind, v.kernel, v.case, v.detail) for v in violations)


@pytest.mark.parametrize("fixture", sorted(PROVIDERS_J))
def test_same_violations_as_the_reference_on_its_fixtures(fixture):
    for g in PROVIDERS_J[fixture]():
        assert _as_tuples(check_geometry(g)) == _as_tuples(
            pallas_check_j.check_geometry(g))


def test_same_verdict_as_the_reference_on_its_production_geometry():
    providers = pallas_check_j.load_registry()
    n = 0
    for name in sorted(providers):
        for g in providers[name]():
            assert _as_tuples(check_geometry(g)) == _as_tuples(
                pallas_check_j.check_geometry(g)) == []
            n += 1
    assert n > 10


def test_same_violations_on_perturbed_reference_geometry():
    """The reference's own cases with a broken index map, a dropped mask
    and an undeclared alias: both checkers find the same faults."""
    import dataclasses

    for g in pallas_check_j.load_registry()["placement"]():
        broken = dataclasses.replace(
            g, aliases={}, outputs=(dataclasses.replace(
                g.outputs[0], index_map=lambda *p: (0,) * 5),
                *g.outputs[1:]))
        want = _as_tuples(pallas_check_j.check_geometry(broken))
        assert want and _as_tuples(check_geometry(broken)) == want


# ---------------------------------------------------------------------------
# declarations and launches
# ---------------------------------------------------------------------------

def _cu_constant(kernel, name, source=0):
    src = _build._sources(kernel)[source].read_text()
    return int(re.search(rf"constexpr int {name} = (\d+)", src).group(1))


def test_grid_helpers_tile_as_the_cuda_sources_do():
    assert placement_t.BLOCK_B == _cu_constant("placement", "kWarps")
    assert fa_t.BLOCK_Q == {
        "simt": _cu_constant("flash_attention", "kBQ", 0),
        "wgmma": _cu_constant("flash_attention", "kBQ", 1)}
    assert ssm_t.THREADS == _cu_constant("ssm_scan", "kThreads")
    assert ssm_t.LANES == _cu_constant("ssm_scan", "kLanes")
    assert ssd_t.BLOCK_P == _cu_constant("ssd_scan", "kPB")
    assert wq_t.WARPS == _cu_constant("window_query", "kWarps")
    assert placement_t.launch_grid(37) == (5,)
    assert placement_t.launch_grid(8192) == (1024,)
    assert fa_t.launch_grid(2, 4, 37, "simt") == (1, 4, 2)
    assert fa_t.launch_grid(1, 16, 4096, "simt") == (64, 16, 1)
    assert fa_t.launch_grid(2, 4, 37, "wgmma") == (1, 4, 2)
    assert fa_t.launch_grid(1, 16, 4096, "wgmma") == (32, 16, 1)
    assert fd_t.launch_grid(4, 32, 32768) == ((16, 8, 4), (32, 4))
    assert fd_t.launch_grid(2, 2, 4097) == ((9, 1, 2), (2, 2))
    assert ssm_t.launch_grid(1, 8192) == (512, 1)
    assert ssm_t.launch_grid(2, 200) == (13, 2)
    assert ssd_t.launch_grid(1, 112, 64) == (4, 112, 1)
    assert ssd_t.launch_grid(2, 3, 64) == (4, 3, 2)
    assert wq_t.launch_grid(300, 32) == (10,)       # 32 rows a block
    assert wq_t.launch_grid(8192, 32) == (256,)     # the fleet's HP view
    assert wq_t.launch_grid(1024, 128) == (128,)    # a warp a row
    assert wq_t.launch_grid(4096, 15) == (64,)      # 64 rows a block


def _chip_smoke():
    """``chip_smoke.py`` from the repository's root, as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_chip_smoke_window_query_case_is_declared_on_its_route():
    """Each case ``chip_smoke.py`` launches the window-query kernels on (made
    here on the host, from the same seeds) is a registered geometry of its
    entry point, at its rows and T·W, and the wrapper's route helper sends
    it down the route the run checks it took."""
    declared = {(g.kernel, g.inputs[0].array_shape)
                for g in load_registry()["window_query"]()}
    seen = set()
    for case, entry, route, xs in _chip_smoke().wq_cases("cpu"):
        shape = (xs[0].shape[:-2].numel(),
                 xs[0].shape[-2] * xs[0].shape[-1])
        assert (entry, shape) in declared, case
        assert wq_t.route(*xs[:3]) == route, case
        seen.add(route)
    assert seen == set(wq_t.ROUTES)


def test_every_chip_smoke_rank_share_is_declared():
    """Each rank share ``chip_smoke.py`` times at a query offset (q
    [B,H,Sq,hd] against k and v [B,K,Sk,hd]) is a registered geometry of
    its route."""
    smoke = _chip_smoke()
    declared = {(g.case.split("-")[0], g.inputs[0].array_shape,
                 g.inputs[1].array_shape)
                for g in load_registry()["flash_attention"]()}
    for c in smoke.OFFSET_CASES[:smoke.OFFSET_TIMED]:
        name, B, H, K, Sq, Sk, _, hd, dt, *_ = c
        assert (fa_t.route(dt), (B, H, Sq, hd), (B, K, Sk, hd)) in \
            declared, name


@pytest.mark.parametrize("kernel,fn,argtypes", [
    ("window_query", "window_query_batched_launch",
     wq_t._BATCHED_ARGTYPES),
    ("window_query", "window_query_launch", wq_t._ARGTYPES),
    ("racy_sum", "racy_sum_launch", racy_kernel._ARGTYPES),
    ("placement", "fanout_commit_launch", placement_t._FANOUT_ARGTYPES),
])
def test_ctypes_signatures_match_the_c_interface(kernel, fn, argtypes):
    """One ctypes type per parameter of each new C entry point, in order
    (ctypes would otherwise pass a pointer as a 32-bit int)."""
    import ctypes

    src = _build._sources(kernel)[0].read_text()
    params = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
    want = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "long long": ctypes.c_longlong, "float": ctypes.c_float}
    kinds = []
    for p in params.split(","):
        words = p.replace("*", "* ").split()[:-1]
        kinds.append("void*" if "void*" in words
                     else " ".join(w for w in words if w != "const"))
    assert [want[k] for k in kinds] == argtypes


def _entry_body(kernel, fn):
    """The body of C entry point ``fn``, in whichever of the kernel's
    sources defines it."""
    src = next(t for t in (p.read_text() for p in _build._sources(kernel))
               if f"int {fn}(" in t)
    body = src[src.index(f"int {fn}("):]
    return body[:body.index("\n}\n")]


@pytest.mark.parametrize("kernel,fn", [
    ("placement", "fused_place_launch"),
    ("placement", "fanout_commit_launch"),
    ("flash_attention", "flash_attention_launch"),
    ("flash_attention", "flash_attention_wgmma_launch"),
    ("flash_decode", "flash_decode_split_launch"),
    ("flash_decode", "flash_decode_combine_launch"),
    ("ssm_scan", "ssm_scan_launch"),
    ("ssd_scan", "ssd_scan_launch"),
    ("window_query", "window_query_batched_launch"),
    ("window_query", "window_query_launch"),
    ("racy_sum", "racy_sum_launch"),
])
def test_c_entry_points_check_the_wrappers_grid(kernel, fn):
    body = _entry_body(kernel, fn)
    assert "int grid_x" in body and "return -2;" in body


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_cli_passes_the_production_registry(capsys):
    assert cli.main([]) == 0
    out = capsys.readouterr().out
    assert "0 violation(s)" in out and "analysis: OK" in out
    for name in PORT_KERNELS:
        assert f"  {name}:" in out


@pytest.mark.parametrize("fixture", ["race", "oob", "alias"])
def test_cli_fails_on_each_fixture(fixture, capsys):
    assert cli.main(["--fixture", fixture]) == 1
    assert "analysis: FAILED" in capsys.readouterr().out
