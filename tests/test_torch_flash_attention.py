"""The port's flash attention against the JAX package on the CPU.

The port's ``attention_ref`` (the CUDA kernel's plain version, the path
CPU tensors take) is held to the JAX package's ``attention_ref`` and to its
Pallas kernel run in interpret mode, at the shapes the JAX package's own
kernel tests sweep (GQA, MQA, sliding window, softcap, non-causal), and to
the JAX ``attention_ref`` alone at ragged sequence lengths, which the Pallas
kernel's block tiling does not take. Inputs are seeded numpy, f32.

The same at a query offset: a rank that holds the rows [s0, s0 + Sq) of a
sequence-sharded q computes them against every key,
``attention_ref(q[:, :, s0:s0 + Sq], k, v, q_offset=s0)``, which must equal
those rows of both JAX references on the whole sequence, with s0 on and
off the CUDA kernels' blocks of 64 and 128 rows; and the kernel route's
autograd keeps the offset for its backward.

Tolerance: 1e-5 absolute. Both sides compute the same f32 masked softmax;
their sums run in different orders, which moves outputs of magnitude ~1 by
a few 1e-7.

The CUDA kernels themselves cannot run here; ``chip_smoke.py`` holds them
to the plain version on the card. What the CPU can check of them is tested
below: the dispatch, the route by dtype (bf16 to the wgmma kernel, f32 to
the SIMT one), the build recipe and the ctypes signatures, and the wgmma
kernel's algebra (tile-wise online softmax, P as two bf16 halves) in plain
torch against both packages' attention_ref within the bf16 tolerance.
"""

import ctypes
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention as flash_attention_j,
)
from repro.kernels.flash_attention.ref import attention_ref as attention_ref_j
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa_t
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import attention_op
from repro_torch.kernels.flash_attention.ref import attention_ref

ATOL = 1e-5
ATTN_TOL_BF16 = 1.6e-2   # chip_smoke.py's ATTN_TOL for bf16: one ulp below 4


def _inputs(B, H, K, S, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, S, hd), (B, K, S, hd), (B, K, S, hd))]


def _port(xs, **kw):
    return attention_ref(*map(torch.from_numpy, xs), **kw).numpy()


# (B, H, K, S, hd, block_q, block_k, options): tests/test_kernels.py's
# sweep and the geometry registrations of the Pallas kernel
KERNEL_CASES = [
    (1, 4, 2, 128, 64, 64, 64, {}),
    (2, 2, 1, 256, 32, 128, 64, {}),                 # MQA, rectangular blocks
    (1, 8, 8, 128, 128, 128, 128, {}),               # MHA
    (1, 4, 4, 64, 64, 64, 64, {}),                   # single block
    (1, 2, 2, 256, 64, 64, 64, {"window": 32}),
    (1, 2, 2, 256, 64, 64, 64, {"window": 128}),
    (1, 2, 2, 128, 64, 64, 64, {"causal": False, "softcap": 20.0}),
    (1, 4, 2, 128, 64, 64, 64, {"window": 48, "softcap": 50.0}),
]


def _case_id(i):
    return "B{}H{}K{}S{}hd{}bq{}bk{}".format(*KERNEL_CASES[i][:7]) + "".join(
        f"-{k}{v}" for k, v in KERNEL_CASES[i][7].items())


@functools.lru_cache(maxsize=None)
def _whole(i):
    """KERNEL_CASES[i]'s inputs and the JAX package's attention_ref and
    Pallas kernel (interpret mode) on the whole sequence."""
    B, H, K, S, hd, bq, bk, kw = KERNEL_CASES[i]
    xs = _inputs(B, H, K, S, hd, seed=S + hd)
    js = [jnp.asarray(x) for x in xs]
    ref = np.asarray(attention_ref_j(*js, **kw))
    ker = np.asarray(flash_attention_j(*js, block_q=bq, block_k=bk,
                                       interpret=True, **kw))
    return xs, ref, ker


@pytest.mark.parametrize("i", range(len(KERNEL_CASES)), ids=_case_id)
def test_attention_ref_matches_jax_ref_and_pallas_kernel(i):
    B, H, K, S, hd, _, _, kw = KERNEL_CASES[i]
    xs, ref, ker = _whole(i)
    got = _port(xs, **kw)
    assert got.shape == (B, H, S, hd) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ker, rtol=0, atol=ATOL)


RAGGED_KW = pytest.mark.parametrize("kw", [
    {}, {"window": 8, "softcap": 20.0}, {"causal": False},
    {"causal": False, "window": 16},
], ids=["causal", "window8-softcap20", "bidirectional", "bidirectional-w16"])


@pytest.mark.parametrize("S", [37, 173])
@RAGGED_KW
def test_attention_ref_ragged_matches_jax_ref(S, kw):
    xs = _inputs(2, 4, 2, S, 32, seed=S)
    got = _port(xs, **kw)
    ref = np.asarray(attention_ref_j(*map(jnp.asarray, xs), **kw))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# a query offset: a rank's share of a sequence-sharded q
# ---------------------------------------------------------------------------

def _shares(S):
    """(s0, Sq) of a share: the last half (the heaviest rank's rows under
    causal masking), s0 on the CUDA kernels' blocks of 64 and 128 rows at S
    128 and 256, and a ragged share whose first row lies off every
    block."""
    return {"last-half": (S // 2, S - S // 2),
            "off-block": (S // 3 + 1, S // 4 + 3)}


SHARES = pytest.mark.parametrize("share", ["last-half", "off-block"])


def _rows(xs, s0, Sq, **kw):
    """The port's attention_ref of q's rows [s0, s0 + Sq) at their offset
    against every key."""
    q, k, v = map(torch.from_numpy, xs)
    out = attention_ref(q[:, :, s0:s0 + Sq], k, v, q_offset=s0, **kw)
    assert out.shape == (q.shape[0], q.shape[1], Sq, q.shape[3])
    return out.numpy()


@SHARES
@pytest.mark.parametrize("i", range(len(KERNEL_CASES)), ids=_case_id)
def test_offset_rows_match_jax_ref_and_pallas_kernel(i, share):
    kw = KERNEL_CASES[i][7]
    xs, ref, ker = _whole(i)
    s0, Sq = _shares(xs[0].shape[2])[share]
    got = _rows(xs, s0, Sq, **kw)
    np.testing.assert_allclose(got, ref[:, :, s0:s0 + Sq], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ker[:, :, s0:s0 + Sq], rtol=0, atol=ATOL)


@pytest.mark.parametrize("S", [37, 173])
@RAGGED_KW
@SHARES
def test_ragged_offset_rows_match_jax_ref(S, kw, share):
    xs = _inputs(2, 4, 2, S, 32, seed=S + 1)
    ref = np.asarray(attention_ref_j(*map(jnp.asarray, xs), **kw))
    s0, Sq = _shares(S)[share]
    np.testing.assert_allclose(_rows(xs, s0, Sq, **kw),
                               ref[:, :, s0:s0 + Sq], rtol=0, atol=ATOL)


@pytest.mark.parametrize("kw", [{}, {"window": 8, "softcap": 20.0}],
                         ids=["causal", "window8-softcap20"])
def test_shares_concatenate_to_the_whole(kw):
    """Four shares of S 100 (25 rows each), each at its offset, put
    together give the whole sequence's attention."""
    xs = _inputs(1, 4, 2, 100, 32, seed=11)
    whole = attention_ref(*map(torch.from_numpy, xs), **kw).numpy()
    parts = [_rows(xs, s0, 25, **kw) for s0 in range(0, 100, 25)]
    np.testing.assert_allclose(np.concatenate(parts, axis=2), whole, rtol=0,
                               atol=ATOL)


def test_no_offset_is_the_whole_sequence():
    xs = [torch.from_numpy(x) for x in _inputs(2, 4, 2, 37, 32, seed=2)]
    kw = dict(window=8, softcap=20.0)
    assert torch.equal(attention_ref(*xs, q_offset=0, **kw),
                       attention_ref(*xs, **kw))


def test_kernel_route_keeps_the_offset_for_its_backward(monkeypatch):
    """``attention_op(..., q_offset=s0, backend="kernel")`` with the kernel
    swapped for its plain version (on the card the CUDA kernel computes
    it): the kernel is called with the offset, and the output and the
    gradients of q, k and v equal the plain route's autograd (the backward
    recomputes attention_ref at the same offset)."""
    calls = []

    def fake_kernel(*xs, **kw):
        assert not torch.is_grad_enabled()
        calls.append(kw["q_offset"])
        return attention_ref(*xs, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention", fake_kernel)
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((2, 4, 10, 32), (2, 2, 24, 32), (2, 2, 24, 32))]
    w = torch.from_numpy(rng.standard_normal((2, 4, 10, 32)).astype(
        np.float32))
    kw = dict(causal=True, window=8, softcap=20.0, q_offset=9)
    out, grads = {}, {}
    for backend in ("kernel", "ref"):
        leaves = [x.clone().requires_grad_(True) for x in xs]
        y = attention_op(*leaves, backend=backend, **kw)
        (y * w).sum().backward()
        out[backend] = y.detach()
        grads[backend] = [x.grad for x in leaves]
    assert calls == [9]
    torch.testing.assert_close(out["kernel"], out["ref"], rtol=0, atol=0)
    for gk, gr in zip(grads["kernel"], grads["ref"]):
        torch.testing.assert_close(gk, gr, rtol=0, atol=0)


def test_attention_ref_keeps_bf16():
    xs = _inputs(1, 2, 1, 37, 64, seed=3)
    q, k, v = (torch.from_numpy(x).bfloat16() for x in xs)
    out = attention_ref(q, k, v, window=8)
    assert out.dtype == torch.bfloat16
    ref = attention_ref(q.float(), k.float(), v.float(), window=8)
    assert torch.equal(out, ref.bfloat16())


# ---------------------------------------------------------------------------
# the wgmma kernel's algebra, in plain torch
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
NEG_INF = -1e30


def _wgmma_algebra(q, k, v, *, causal=True, window=0, softcap=0.0,
                   bq=128, bk=128, q_offset=0):
    """The bf16 kernel's arithmetic (csrc/flash_attention_wgmma.cu) on the
    host, tile by tile: blocks of ``bq`` of q's Sq rows, row i at position
    ``q_offset + i``, over the key tiles of ``bk`` of the Sk keys that the
    masks leave partly visible at those positions; the scale folded into
    the exponent (or scores scaled and capped first); masked scores -1e30
    on a tile that ``all_visible`` does not find wholly visible to a
    warpgroup's 64 rows, and an exponent offset of +inf for a row that has
    seen no key yet, so a masked p is 0 exactly; p split into bf16 halves
    hi + lo for the P V product; l summing the f32 p; O / max(l, 1e-30)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    group = H // k.shape[1]
    scale = hd ** -0.5
    sl = LOG2E if softcap > 0 else scale * LOG2E
    out = torch.empty(q.shape, dtype=torch.float32)
    local, pos = torch.arange(Sq), torch.arange(Sk)

    def all_visible(k0, p_lo):
        return (k0 + bk <= Sk and (not causal or k0 + bk - 1 <= p_lo)
                and (window <= 0 or p_lo + 63 - k0 < window))

    for b in range(B):
        for h in range(H):
            qf = q[b, h].float()
            kf, vf = k[b, h // group].float(), v[b, h // group].float()
            for q0 in range(0, Sq, bq):
                rows = local[q0:q0 + bq]
                qpos = q_offset + rows
                q_last = min(q0 + bq, Sq) - 1
                k_end = q_offset + q_last + 1 if causal else Sk
                k_begin = (max(0, q_offset + q0 - window + 1) if window > 0
                           else 0)
                m = torch.full((len(rows),), NEG_INF)
                l = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), hd)
                for k0 in range(k_begin // bk * bk, k_end, bk):
                    keys = pos[k0:k0 + bk]
                    s = qf[rows] @ kf[keys].T
                    if softcap > 0:
                        s = torch.tanh(s * (scale / softcap)) * softcap
                    vis = torch.ones(s.shape, dtype=torch.bool)
                    if causal:
                        vis &= qpos[:, None] >= keys[None, :]
                    if window > 0:
                        vis &= qpos[:, None] - keys[None, :] < window
                    # each warpgroup's 64 rows skip the mask on a tile
                    # all_visible finds wholly visible to them
                    for w0 in range(0, len(rows), 64):
                        if all_visible(k0, q_offset + q0 + w0):
                            vis[w0:w0 + 64] = True
                    s = torch.where(vis, s, NEG_INF)
                    mn = torch.maximum(m, s.amax(-1))
                    a = torch.exp2((m - mn) * sl)
                    ms = torch.where(mn == NEG_INF, torch.inf, mn * sl)
                    p = torch.exp2(s * sl - ms[:, None])
                    hi = p.bfloat16().float()
                    lo = (p - hi).bfloat16().float()
                    acc = acc * a[:, None] + hi @ vf[keys] + lo @ vf[keys]
                    l = l * a + p.sum(-1)
                    m = mn
                out[b, h, rows] = acc / l.clamp_min(1e-30)[:, None]
    return out.bfloat16()


# the small shapes of chip_smoke.py's ATTN_CASES (waste S 173, ragged,
# bidirectional) in bf16, and a narrow tile that leaves windowed rows a
# first tile with nothing visible; then q's rows [s0, s0 + Sq) of S at
# their offset ("rows": (s0, Sq)), s0 on and off the block, Sq ragged
ALGEBRA_CASES = [
    (1, 8, 8, 173, 64, {}),
    (2, 4, 2, 37, 32, {"window": 8, "softcap": 20.0}),
    (1, 4, 2, 300, 128, {"causal": False}),
    (1, 2, 1, 200, 112, {"window": 40, "bk": 16, "bq": 32}),
    (1, 2, 2, 130, 256, {"softcap": 50.0, "bk": 64}),
    (1, 8, 8, 173, 64, {"rows": (45, 100)}),
    (1, 4, 2, 512, 128, {"rows": (256, 256)}),
    (1, 2, 1, 200, 112, {"window": 40, "bk": 16, "bq": 32,
                         "rows": (96, 70)}),
    (2, 4, 2, 300, 128, {"causal": False, "window": 30, "rows": (128, 128)}),
    (1, 2, 2, 330, 256, {"window": 100, "softcap": 50.0, "bk": 64,
                         "rows": (200, 130)}),
]


@pytest.mark.parametrize("case", ALGEBRA_CASES,
                         ids=lambda c: "B{}H{}K{}S{}hd{}".format(*c[:5])
                         + "".join(f"-{k}{v}" for k, v in c[5].items()))
def test_wgmma_algebra_matches_the_references(case):
    """The kernel's tile-wise online softmax with P as bf16 halves, held to
    the port's and the JAX package's attention_ref within ATTN_TOL[bf16];
    at an offset, to the port's at that offset and to the JAX package's
    rows of the whole sequence."""
    B, H, K, S, hd, kw = case
    kw = dict(kw)
    tiles = {t: kw.pop(t) for t in ("bq", "bk") if t in kw}
    s0, Sq = kw.pop("rows", (0, S))
    xs = [torch.from_numpy(x).bfloat16()
          for x in _inputs(B, H, K, S, hd, seed=7 * S + hd)]
    q = xs[0][:, :, s0:s0 + Sq]
    got = _wgmma_algebra(q, *xs[1:], q_offset=s0, **kw, **tiles)
    want = attention_ref(q, *xs[1:], q_offset=s0, **kw)
    jax_want = np.asarray(attention_ref_j(
        *(jnp.asarray(x.float().numpy()) for x in xs), **kw))[
        :, :, s0:s0 + Sq]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0, atol=ATTN_TOL_BF16)
    np.testing.assert_allclose(got.float().numpy(), jax_want, rtol=0,
                               atol=ATTN_TOL_BF16)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_auto_and_ref_backends_take_the_plain_version_on_cpu():
    xs = [torch.from_numpy(x) for x in _inputs(1, 4, 2, 37, 32, seed=1)]
    launches = fa_t.launches
    want = attention_ref(*xs, window=8, softcap=20.0)
    for backend in ("auto", "ref"):
        got = attention_op(*xs, window=8, softcap=20.0, backend=backend)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fa_t.launches == launches


def test_kernel_backend_raises_on_cpu_tensors():
    xs = [torch.from_numpy(x) for x in _inputs(1, 4, 2, 37, 32, seed=1)]
    launches = fa_t.launches
    with pytest.raises(ValueError, match="CUDA"):
        attention_op(*xs, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        fa_t.flash_attention(*xs)
    assert fa_t.launches == launches


def test_unknown_backend_raises():
    xs = [torch.from_numpy(x) for x in _inputs(1, 2, 2, 8, 32, seed=1)]
    with pytest.raises(ValueError, match="backend"):
        attention_op(*xs, backend="tpu")


# ---------------------------------------------------------------------------
# the kernel's build and binding
# ---------------------------------------------------------------------------

def test_kernel_build_recipe():
    """The kernels build from the package's own sources (the SIMT kernel for
    f32, the wgmma kernel for bf16) for sm_90a without fast math, and the
    wrapper accepts exactly the head dims both sources instantiate."""
    srcs = _build._sources("flash_attention")
    assert [p.name for p in srcs] == ["flash_attention.cu",
                                      "flash_attention_wgmma.cu"]
    assert all(p.is_relative_to(Path(_build.__file__).parent) for p in srcs)
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags
    simt, wgmma = (p.read_text() for p in srcs)
    built = {int(m) for m in re.findall(r"case (\d+):\s*return launch<T,",
                                        simt)}
    assert built == set(fa_t.HEAD_DIMS)
    assert _build._lib_path("flash_attention").parent == _build.BUILD_DIR


def test_wgmma_source_instantiates_the_head_dims():
    """Each case of the wgmma entry point's switch launches its own head
    dim, and the cases are HEAD_DIMS."""
    src = _build._sources("flash_attention")[1].read_text()
    cases = re.findall(r"case (\d+):\s*return launch<(\d+)>", src)
    assert all(a == b for a, b in cases)
    assert {int(a) for a, _ in cases} == set(fa_t.HEAD_DIMS)


def test_wgmma_source_uses_the_tensor_cores_and_tma():
    """Both products are wgmma (the score product with both operands in
    shared memory, P V with P from registers and v transposed), the copies
    TMA under mbarriers, and the registers go to the consumers."""
    src = _build._sources("flash_attention")[1].read_text()
    for ptx in ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                "cp.async.bulk.tensor.3d", "mbarrier.try_wait.parity",
                "mbarrier.arrive.expect_tx", "setmaxnreg.inc",
                "setmaxnreg.dec", "const __grid_constant__ CUtensorMap"):
        assert ptx in src, ptx
    assert "}, %32, %33, p, 1, 1, 0, 0;" in src      # SS: K-major, K-major
    assert "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;" in src   # RS, tnspB


def _entry_params(src: str, fn: str) -> list:
    params = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
    kinds = []
    for decl in params.split(","):
        decl = decl.strip()
        kinds.append("p" if "*" in decl else decl.split()[0])
    want = {"p": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}
    return [want[k] for k in kinds]


@pytest.mark.parametrize("src,fn", [
    (0, "flash_attention_launch"), (1, "flash_attention_wgmma_launch"),
], ids=["simt", "wgmma"])
def test_ctypes_signature_matches_the_c_entry_point(src, fn):
    """One ctypes type per parameter of each route's C entry point, in
    order (ctypes would otherwise pass a pointer as a 32-bit int)."""
    text = _build._sources("flash_attention")[src].read_text()
    assert _entry_params(text, fn) == fa_t._ARGTYPES
    assert fa_t._ENTRY[fa_t.ROUTES[{0: torch.float32,
                                     1: torch.bfloat16}[src]]] == fn


def test_route_follows_from_the_dtype_alone():
    """bf16 takes the wgmma kernel, f32 the SIMT one; nothing else is
    taken; each route's grid tiles by its own block of query rows."""
    assert fa_t.route(torch.bfloat16) == "wgmma"
    assert fa_t.route(torch.float32) == "simt"
    for dt in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(ValueError, match="dtype"):
            fa_t.route(dt)
    assert fa_t.launch_grid(1, 8, 173, "wgmma") == (2, 8, 1)
    assert fa_t.launch_grid(1, 8, 173, "simt") == (3, 8, 1)
    import inspect
    assert "route" not in inspect.signature(fa_t.flash_attention).parameters

