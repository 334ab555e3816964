"""The port's SSM layers and scan kernels against the JAX package on the
CPU.

The plain versions of the two scan kernels (``ssm_scan_ref``,
``ssd_scan_ref``: the CUDA kernels' oracles) are held to the JAX package's
oracles and to its Pallas kernels run in interpret mode, at shapes whose
sequences span several chunks, so the state the Pallas kernels carry in
scratch from chunk to chunk is exercised; and to the JAX oracles alone at
ragged S, which the Pallas tiling does not take. The Mamba-1 and Mamba-2
blocks (``_causal_conv``, the chunked CPU scans, forward and decode) are
fed the same seeded numpy weights and inputs as ``repro.models.ssm``.
Everything in f32.

Tolerances, stated with their reasons:
- scans: 2e-5 absolute on outputs of magnitude up to ~10. The same f32
  recurrence; the JAX oracle's ``lax.scan``, the Pallas kernel's chunked
  form and the port's loop sum in different orders.
- blocks and their parts: 2e-5 absolute. The same f32 formulas through a
  few matmuls; XLA and PyTorch round their matmuls and transcendentals
  differently in the last bits, and the JAX block's associative scan
  orders the sums otherwise.

The CUDA kernels themselves cannot run here; ``chip_smoke.py`` holds them
to the plain versions on the card. Tested below of them: the dispatch, the
build recipe and the ctypes signatures.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_scan_ref as ssd_ref_j
from repro.kernels.ssd_scan.ssd_scan import ssd_scan as ssd_pallas
from repro.kernels.ssm_scan.ref import ssm_scan_ref as ssm_ref_j
from repro.kernels.ssm_scan.ssm_scan import ssm_scan as ssm_pallas
from repro.models import ssm as ssm_j
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_t
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_t
from repro_torch.kernels.ssm_scan.ops import ssm_scan_op
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models import ssm as ssm_m

ATOL = 2e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _uniform(rng, lo, hi, *shape):
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def _both(fn_j, fn_t, *xs, **kw):
    ref = fn_j(*map(jnp.asarray, xs), **kw)
    got = fn_t(*map(torch.from_numpy, xs), **kw)
    return np.asarray(ref), got.numpy()


# ---------------------------------------------------------------------------
# the scans' plain versions
# ---------------------------------------------------------------------------

def _ssm_inputs(B, S, di, N, seed):
    rng = _rng(seed)
    return (_normal(rng, B, S, di), _uniform(rng, 0.001, 0.1, B, S, di),
            -_uniform(rng, 0.5, 2.0, di, N), _normal(rng, B, S, N),
            _normal(rng, B, S, N))


def _ssd_inputs(B, S, H, P, N, seed):
    rng = _rng(seed)
    return (_normal(rng, B, S, H, P), _uniform(rng, 0.001, 0.1, B, S, H),
            -_uniform(rng, 0.5, 2.0, H), _normal(rng, B, S, N),
            _normal(rng, B, S, N))


# (B, S, di, N, block_d, chunk): the JAX package's kernel sweep; S spans
# 2-4 chunks, so the carried state matters
@pytest.mark.parametrize("B,S,di,N,bd,chunk", [
    (1, 64, 64, 8, 32, 32), (2, 128, 128, 16, 128, 64),
    (1, 96, 32, 16, 32, 32),
])
def test_ssm_scan_ref_matches_jax_ref_and_pallas_kernel(B, S, di, N, bd,
                                                        chunk):
    xs = _ssm_inputs(B, S, di, N, seed=S + di)
    ref, got = _both(ssm_ref_j, ssm_scan_ref, *xs)
    ker = np.asarray(ssm_pallas(*map(jnp.asarray, xs), block_d=bd,
                                chunk=chunk, interpret=True))
    assert got.shape == (B, S, di) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ker, rtol=0, atol=ATOL)


@pytest.mark.parametrize("S", [1, 37])
def test_ssm_scan_ref_ragged_matches_jax_ref(S):
    ref, got = _both(ssm_ref_j, ssm_scan_ref, *_ssm_inputs(2, S, 24, 16, S))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_ssm_scan_state_carries_across_chunks():
    """One impulse at t = 0 with a slow decay is still visible at the last
    step, in the port and in the Pallas kernel (chunk 32, S 128)."""
    B, S, di, N = 1, 128, 32, 4
    u = np.zeros((B, S, di), np.float32)
    u[:, 0] = 1.0
    xs = (u, np.full((B, S, di), 0.01, np.float32),
          np.full((di, N), -0.1, np.float32), np.ones((B, S, N), np.float32),
          np.ones((B, S, N), np.float32))
    got = ssm_scan_ref(*map(torch.from_numpy, xs)).numpy()
    ker = np.asarray(ssm_pallas(*map(jnp.asarray, xs), block_d=32, chunk=32,
                                interpret=True))
    assert np.abs(got[0, -1]).max() > 1e-4
    np.testing.assert_allclose(got, ker, rtol=0, atol=ATOL)


# (B, S, H, P, N, block_h, chunk)
@pytest.mark.parametrize("B,S,H,P,N,bh,chunk", [
    (1, 64, 4, 16, 8, 4, 32), (2, 128, 8, 32, 16, 4, 64),
    (1, 96, 2, 64, 32, 2, 32),
])
def test_ssd_scan_ref_matches_jax_ref_and_pallas_kernel(B, S, H, P, N, bh,
                                                        chunk):
    xs = _ssd_inputs(B, S, H, P, N, seed=S + H)
    ref, got = _both(ssd_ref_j, ssd_scan_ref, *xs)
    ker = np.asarray(ssd_pallas(*map(jnp.asarray, xs), block_h=bh,
                                chunk=chunk, interpret=True))
    assert got.shape == (B, S, H, P) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ker, rtol=0, atol=ATOL)


@pytest.mark.parametrize("S", [1, 45])
def test_ssd_scan_ref_ragged_matches_jax_ref(S):
    ref, got = _both(ssd_ref_j, ssd_scan_ref, *_ssd_inputs(2, S, 3, 64, 64,
                                                           S))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_ssd_scan_state_carries_across_chunks():
    B, S, H, P, N = 1, 96, 2, 8, 4
    x = np.zeros((B, S, H, P), np.float32)
    x[:, 0] = 1.0
    xs = (x, np.full((B, S, H), 0.01, np.float32),
          np.full((H,), -0.1, np.float32), np.ones((B, S, N), np.float32),
          np.ones((B, S, N), np.float32))
    got = ssd_scan_ref(*map(torch.from_numpy, xs)).numpy()
    ker = np.asarray(ssd_pallas(*map(jnp.asarray, xs), block_h=2, chunk=32,
                                interpret=True))
    assert np.abs(got[0, -1]).max() > 1e-5
    np.testing.assert_allclose(got, ker, rtol=0, atol=ATOL)


def test_scan_refs_keep_the_input_dtype():
    xs = [torch.from_numpy(x) for x in _ssm_inputs(1, 9, 16, 16, 0)]
    u, dt, A, B, C = xs
    out = ssm_scan_ref(u.bfloat16(), dt.bfloat16(), A, B.bfloat16(),
                       C.bfloat16())
    assert out.dtype == torch.bfloat16
    xs = [torch.from_numpy(x) for x in _ssd_inputs(1, 9, 2, 32, 16, 0)]
    x, dt, A, B, C = xs
    out = ssd_scan_ref(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16())
    assert out.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the blocks and their parts
# ---------------------------------------------------------------------------

def test_softplus_matches_jax():
    x = np.linspace(-40, 40, 1001, dtype=np.float32)
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(ssm_m.softplus(torch.from_numpy(x)).numpy(),
                               ref, rtol=0, atol=1e-6)


def test_causal_conv_matches():
    rng = _rng(4)
    x, w, b = _normal(rng, 2, 13, 24), _normal(rng, 4, 24), _normal(rng, 24)
    ref, got = _both(ssm_j._causal_conv, ssm_m._causal_conv, x, w, b)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_selective_scan_chunked_matches():
    u, dt, A, B, C = _ssm_inputs(2, 48, 32, 16, 5)
    ref = ssm_j._selective_scan_chunked(*map(jnp.asarray, (u, dt, A, B, C)),
                                        16)
    got = ssm_m._selective_scan_chunked(*map(torch.from_numpy,
                                             (u, dt, A, B, C)), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_ssd_chunked_matches():
    xs = _ssd_inputs(2, 48, 4, 32, 16, 6)
    ref = ssm_j._ssd_chunked(*map(jnp.asarray, xs), 16)
    got = ssm_m._ssd_chunked(*map(torch.from_numpy, xs), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def _dims(version):
    kw = dict(d_model=64, d_state=16, d_conv=4, expand=2, version=version,
              head_dim=32, chunk=16)
    return ssm_j.SSMDims(**kw), ssm_m.SSMDims(**kw)


def _block_params(version, seed):
    """A block's parameters as numpy, drawn by the JAX package's
    ``init_ssm`` with its f32 leaves, and the norm scale and conv bias made
    non-zero so that they count."""
    dims_j, _ = _dims(version)
    p = jax.device_get(ssm_j.init_ssm(jax.random.PRNGKey(seed), dims_j,
                                      jnp.float32))
    rng = _rng(seed)
    p = {k: np.array(v) for k, v in p.items()}
    p["conv_b"] = _normal(rng, *p["conv_b"].shape, scale=0.1)
    if version == 2:
        p["norm_scale"] = _normal(rng, *p["norm_scale"].shape, scale=0.1)
    return p


@pytest.mark.parametrize("version", [1, 2], ids=["mamba1", "mamba2"])
def test_block_forward_matches(version):
    dims_j, dims_t = _dims(version)
    p = _block_params(version, seed=version)
    x = _normal(_rng(7), 2, 32, 64)
    fwd_j = ssm_j.mamba1_forward if version == 1 else ssm_j.mamba2_forward
    fwd_t = ssm_m.mamba1_forward if version == 1 else ssm_m.mamba2_forward
    ref = fwd_j({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                dims_j)
    got = fwd_t({k: torch.from_numpy(v) for k, v in p.items()},
                torch.from_numpy(x), dims_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("version", [1, 2], ids=["mamba1", "mamba2"])
def test_block_decode_matches(version):
    """Three steps from a non-zero state and conv buffer: the output, the
    state and the buffer after each."""
    dims_j, dims_t = _dims(version)
    p = _block_params(version, seed=10 + version)
    rng = _rng(8)
    B, di = 2, dims_t.d_inner
    hshape = ((B, di, 16) if version == 1
              else (B, dims_t.n_heads, dims_t.head_dim, 16))
    h, buf = _normal(rng, *hshape, scale=0.5), _normal(rng, B, 3, di)
    dec_j = ssm_j.mamba1_decode if version == 1 else ssm_j.mamba2_decode
    dec_t = ssm_m.mamba1_decode if version == 1 else ssm_m.mamba2_decode
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    hj, bj = jnp.asarray(h), jnp.asarray(buf)
    ht, bt = torch.from_numpy(h), torch.from_numpy(buf)
    for _ in range(3):
        x = _normal(rng, B, 1, 64)
        oj, hj, bj = dec_j(pj, jnp.asarray(x), dims_j, hj, bj)
        ot, ht, bt = dec_t(pt, torch.from_numpy(x), dims_t, ht, bt)
        for a, b in ((ot, oj), (ht, hj), (bt, bj)):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=ATOL)


@pytest.mark.parametrize("version", [1, 2], ids=["mamba1", "mamba2"])
def test_unaligned_forward_raises_in_both_packages(version):
    """S = 20 with chunk 16: the JAX package's chunked scan asserts; the
    port raises the same precondition on both devices."""
    dims_j, dims_t = _dims(version)
    p = _block_params(version, seed=0)
    x = _normal(_rng(9), 1, 20, 64)
    fwd_j = ssm_j.mamba1_forward if version == 1 else ssm_j.mamba2_forward
    fwd_t = ssm_m.mamba1_forward if version == 1 else ssm_m.mamba2_forward
    with pytest.raises(AssertionError):
        fwd_j({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
              dims_j)
    with pytest.raises(ValueError, match="chunk"):
        fwd_t({k: torch.from_numpy(v) for k, v in p.items()},
              torch.from_numpy(x), dims_t)


@pytest.mark.parametrize("version", [1, 2], ids=["mamba1", "mamba2"])
def test_init_ssm_shapes_and_dtypes_match(version):
    """The port draws every leaf of the JAX tree with its shape; in a bf16
    block, ``D``, ``dt_bias``, ``A_log`` and ``D_head`` stay f32 and their
    values are the JAX package's."""
    dims_j, dims_t = _dims(version)
    pj = jax.device_get(ssm_j.init_ssm(jax.random.PRNGKey(0), dims_j,
                                       jnp.bfloat16))
    pt = ssm_m.init_ssm(torch.Generator().manual_seed(0), dims_t,
                        torch.bfloat16, "cpu")
    assert set(pt) == set(pj)
    for k, v in pj.items():
        assert tuple(pt[k].shape) == v.shape, k
        want = torch.float32 if v.dtype == np.float32 else torch.bfloat16
        assert pt[k].dtype == want, k
        if k in ("D", "dt_bias", "A_log", "D_head"):
            # log(exp(x) - 1) at x ~ 1e-3 cancels: one ulp of exp is a
            # relative 1e-6 of the result
            np.testing.assert_allclose(pt[k].numpy(), v, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# dispatch, build and binding
# ---------------------------------------------------------------------------

def _torch_inputs(kernel):
    if kernel == "ssm_scan":
        return [torch.from_numpy(x) for x in _ssm_inputs(1, 9, 16, 16, 1)]
    return [torch.from_numpy(x) for x in _ssd_inputs(1, 9, 2, 64, 64, 1)]


_KERNELS = {"ssm_scan": (ssm_scan_op, ssm_scan_ref, ssm_t, "ssm_scan"),
            "ssd_scan": (ssd_scan_op, ssd_scan_ref, ssd_t, "ssd_scan")}


@pytest.mark.parametrize("kernel", list(_KERNELS))
def test_auto_and_ref_backends_take_the_plain_version_on_cpu(kernel):
    op, ref, mod, _ = _KERNELS[kernel]
    xs = _torch_inputs(kernel)
    launches = mod.launches
    want = ref(*xs)
    for backend in ("auto", "ref"):
        torch.testing.assert_close(op(*xs, backend=backend), want, rtol=0,
                                   atol=0)
    assert mod.launches == launches


@pytest.mark.parametrize("kernel", list(_KERNELS))
def test_kernel_backend_raises_on_cpu_tensors(kernel):
    op, _, mod, fn = _KERNELS[kernel]
    xs = _torch_inputs(kernel)
    launches = mod.launches
    with pytest.raises(ValueError, match="CUDA"):
        op(*xs, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        getattr(mod, fn)(*xs)
    with pytest.raises(ValueError, match="backend"):
        op(*xs, backend="tpu")
    assert mod.launches == launches


def _c_params(kernel):
    src = _build._sources(kernel)[0].read_text()
    params = re.search(rf"int {kernel}_launch\(([^)]*)\)", src).group(1)
    kinds = []
    for decl in params.split(","):
        decl = decl.strip()
        kinds.append("p" if "*" in decl else decl.split()[0])
    want = {"p": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}
    return [want[k] for k in kinds]


@pytest.mark.parametrize("kernel", list(_KERNELS))
def test_ctypes_signature_matches_the_c_entry_point(kernel):
    """One ctypes type per parameter of ``<kernel>_launch``, in order
    (ctypes would otherwise pass a pointer as a 32-bit int)."""
    assert _c_params(kernel) == _KERNELS[kernel][2]._ARGTYPES


def test_scan_build_recipes():
    """Each kernel builds from its package's own single source, and the
    wrapper accepts exactly the shapes the source instantiates."""
    for kernel in _KERNELS:
        srcs = _build._sources(kernel)
        assert [p.name for p in srcs] == [f"{kernel}.cu"]
        assert srcs[0].is_relative_to(Path(_build.__file__).parent)
    ssm_src = _build._sources("ssm_scan")[0].read_text()
    built = {int(m) for m in re.findall(r"case (\d+):\s*return launch<T,",
                                        ssm_src)}
    assert built == set(ssm_t.STATE_DIMS)
    ssd_src = _build._sources("ssd_scan")[0].read_text()
    built = {(int(p), int(n)) for p, n in re.findall(
        r"if \(P == (\d+) && N == (\d+)\)", ssd_src)}
    assert built == set(ssd_t.SHAPES)
