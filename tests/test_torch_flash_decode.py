"""The port's decode attention against the JAX package on the CPU.

The port's ``decode_attention_ref`` (the CUDA kernel's plain version) takes
the caches in the decode state's layout ``[B,S,K,hd]``; the JAX package's
oracle and Pallas kernel take ``[B,K,S,hd]``, so the tests hand them the
same seeded numpy caches transposed. Held to both the JAX oracle and the
Pallas kernel in interpret mode at the shapes of the JAX package's own
sweep (GQA, MQA, window, softcap) plus zamba2's head dim 112, and to the
oracle alone at cache lengths the Pallas tiling does not take. Then
``layers.attention_decode``'s CPU path against the JAX package's, caches
included, over several steps. Everything in f32.

Tolerance: 2e-5 absolute on outputs of magnitude ~1, as the JAX package's
own kernel tests use: the same f32 masked softmax, summed in other orders.

The CUDA kernels cannot run here; ``chip_smoke.py`` holds them to the plain
version on the card. Tested below of them: the dispatch, the build recipe,
the ctypes signatures, the shared-memory check, the chunk rule (from the
shapes, never from pos), and the split-and-combine algebra in plain torch
against the JAX package's oracle and Pallas kernel.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.flash_decode import flash_decode as fd_pallas
from repro.kernels.flash_decode.ref import decode_attention_ref as ref_j
from repro.models import layers as L_j
from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import flash_decode as fd_t
from repro_torch.kernels.flash_decode.ops import decode_attention_op
from repro_torch.kernels.flash_decode.ref import (
    decode_attention_ref,
    decode_combine_ref,
    decode_partials_ref,
)
from repro_torch.models import layers as L_t

ATOL = 2e-5


def _inputs(B, H, K, S, hd, seed, pos=None):
    """q [B,H,hd], caches [B,S,K,hd] and pos [B] int32 (the last row's pos
    is 0, the others seeded)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    if pos is None:
        pos = rng.integers(0, S, B)
        pos[-1] = 0
    return q, k, v, np.asarray(pos, np.int32)


def _jax(fn, q, k, v, pos, **kw):
    t = (0, 2, 1, 3)
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k.transpose(t)),
                         jnp.asarray(v.transpose(t)), jnp.asarray(pos),
                         **kw))


def _port(q, k, v, pos, **kw):
    return decode_attention_ref(*map(torch.from_numpy, (q, k, v, pos)),
                                **kw).numpy()


# (B, H, K, S, hd, block_s, options): tests/test_kernels.py's sweep, the
# Pallas kernel's geometries and zamba2's head dim
KERNEL_CASES = [
    (2, 8, 2, 256, 64, 128, {}),                     # GQA 4
    (1, 4, 4, 512, 128, 256, {}),
    (3, 2, 1, 128, 32, 64, {}),                      # MQA
    (2, 4, 4, 256, 112, 128, {}),                    # zamba2's hd
    (2, 4, 2, 256, 64, 64, {"window": 32}),
    (2, 8, 2, 256, 64, 128, {"window": 100, "softcap": 30.0}),
]


@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=lambda c: "B{}H{}K{}S{}hd{}bs{}".format(
                             *c[:6]) + "".join(f"-{k}{v}" for k, v in
                                               c[6].items()))
def test_decode_ref_matches_jax_ref_and_pallas_kernel(case):
    B, H, K, S, hd, bs, kw = case
    xs = _inputs(B, H, K, S, hd, seed=S + hd)
    got = _port(*xs, **kw)
    ref = _jax(ref_j, *xs, **kw)
    ker = _jax(fd_pallas, *xs, block_s=bs, interpret=True, **kw)
    assert got.shape == (B, H, hd) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ker, rtol=0, atol=ATOL)


@pytest.mark.parametrize("S", [1, 77, 301])
@pytest.mark.parametrize("kw", [{}, {"window": 16, "softcap": 20.0}],
                         ids=["global", "window16-softcap20"])
def test_decode_ref_ragged_matches_jax_ref(S, kw):
    xs = _inputs(3, 8, 2, S, 112, seed=S)
    np.testing.assert_allclose(_port(*xs, **kw), _jax(ref_j, *xs, **kw),
                               rtol=0, atol=ATOL)


def test_only_keys_up_to_pos_count():
    """Keys past pos, and keys outside the window, do not change the
    output: overwriting them with large values leaves it as it was."""
    q, k, v, pos = _inputs(2, 4, 2, 64, 32, seed=1, pos=[40, 10])
    base = _port(q, k, v, pos, window=8)
    k2, v2 = k.copy(), v.copy()
    for b, p in enumerate(pos):
        k2[b, p + 1:] = v2[b, p + 1:] = 1e3
        k2[b, : p - 7] = v2[b, : p - 7] = -1e3
    np.testing.assert_array_equal(_port(q, k2, v2, pos, window=8), base)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (9, 0.0), (0, 20.0)])
def test_partials_of_slices_combine_to_the_whole(window, cap):
    """The split pass's plain version over four slices of the cache, each
    at its own positions (``pos`` less the slice's first, some slices with
    no visible key), its partials concatenated in order and combined:
    ``decode_attention_ref`` of the whole cache, as a cache sharded on
    its sequence is computed on a mesh."""
    g = torch.Generator().manual_seed(5)
    B, S, H, K, hd = 3, 32, 4, 2, 16
    q = torch.randn(B, H, hd, generator=g)
    k, v = torch.randn(B, S, K, hd, generator=g), torch.randn(
        B, S, K, hd, generator=g)
    pos = torch.tensor([2, 17, 31], dtype=torch.int32)
    parts = [decode_partials_ref(q, k[:, s0:s0 + 8], v[:, s0:s0 + 8],
                                 pos - s0, window=window, softcap=cap)
             for s0 in range(0, S, 8)]
    got = decode_combine_ref(torch.cat([p[0] for p in parts], dim=2),
                             torch.cat([p[1] for p in parts], dim=2),
                             q.dtype)
    want = decode_attention_ref(q, k, v, pos, window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_decode_ref_keeps_bf16():
    q, k, v, pos = (torch.from_numpy(x) for x in _inputs(2, 4, 2, 40, 64, 2))
    out = decode_attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16(), pos)
    assert out.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# attention_decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,K,window,cap,bias", [
    (4, 4, -1, 0.0, False),
    (4, 2, 8, 50.0, False),
    (8, 2, -1, 0.0, True),
])
def test_attention_decode_cpu_path_matches(H, K, window, cap, bias):
    """Three steps from a half-filled cache: the output and both caches
    after each; the port writes its caches in place."""
    rng = np.random.default_rng(H + K)
    D, hd, B, S = 64, 32, 2, 24
    p = {"wq": rng.standard_normal((D, H, hd)) * D ** -0.5,
         "wk": rng.standard_normal((D, K, hd)) * D ** -0.5,
         "wv": rng.standard_normal((D, K, hd)) * D ** -0.5,
         "wo": rng.standard_normal((H, hd, D)) * (H * hd) ** -0.5}
    if bias:
        p.update(bq=rng.standard_normal((H, hd)),
                 bk=rng.standard_normal((K, hd)),
                 bv=rng.standard_normal((K, hd)))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    ck = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    cv = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    pos = np.array([11, 3], np.int32)
    dims_j = L_j.AttnDims(H, K, hd, 1e4, cap)
    dims_t = L_t.AttnDims(H, K, hd, 1e4, cap)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    ckj, cvj = jnp.asarray(ck), jnp.asarray(cv)
    ckt, cvt = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    for step in range(3):
        x = rng.standard_normal((B, 1, D)).astype(np.float32)
        oj, ckj, cvj = L_j.attention_decode(pj, jnp.asarray(x), dims_j, ckj,
                                            cvj, jnp.asarray(pos + step),
                                            window)
        ot, ck_out, cv_out = L_t.attention_decode(
            pt, torch.from_numpy(x), dims_t, ckt, cvt,
            torch.from_numpy(pos + step), window)
        assert ck_out is ckt and cv_out is cvt
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(ckt.numpy(), np.asarray(ckj), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(cvt.numpy(), np.asarray(cvj), rtol=0,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# dispatch, build and binding
# ---------------------------------------------------------------------------

def _torch_inputs():
    return [torch.from_numpy(x) for x in _inputs(2, 4, 2, 37, 32, seed=5)]


def _counts():
    """The wrapper's counters: calls, split launches, combine launches."""
    return fd_t.launches, fd_t.launches_split, fd_t.launches_combine


def test_auto_and_ref_backends_take_the_plain_version_on_cpu():
    xs = _torch_inputs()
    launches = _counts()
    want = decode_attention_ref(*xs, window=8, softcap=20.0)
    for backend in ("auto", "ref"):
        got = decode_attention_op(*xs, window=8, softcap=20.0,
                                  backend=backend)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert _counts() == launches


def test_kernel_backend_raises_on_cpu_tensors():
    xs = _torch_inputs()
    launches = _counts()
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_op(*xs, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        fd_t.flash_decode(*xs)
    with pytest.raises(ValueError, match="backend"):
        decode_attention_op(*xs, backend="tpu")
    assert _counts() == launches


def test_kernel_build_recipe():
    """The kernels build from the package's own source, and the wrapper
    accepts exactly the head dims and groups the source instantiates."""
    srcs = _build._sources("flash_decode")
    assert [p.name for p in srcs] == ["flash_decode.cu"]
    assert srcs[0].is_relative_to(Path(_build.__file__).parent)
    text = srcs[0].read_text()
    built = {int(m) for m in re.findall(
        r"case (\d+):\s*return launch_group<T, (?:\d+)>", text)}
    assert built == set(fd_t.HEAD_DIMS)
    for name, value in (("kWarps", fd_t._WARPS),
                        ("kMaxGroup", fd_t.MAX_GROUP)):
        got = int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
        assert got == value, name


@pytest.mark.parametrize("fn,argtypes", [
    ("flash_decode_split_launch", fd_t._SPLIT_ARGTYPES),
    ("flash_decode_combine_launch", fd_t._COMBINE_ARGTYPES),
], ids=["split", "combine"])
def test_ctypes_signature_matches_the_c_entry_point(fn, argtypes):
    """One ctypes type per parameter of each C entry point, in order
    (ctypes would otherwise pass a pointer as a 32-bit int)."""
    src = _build._sources("flash_decode")[0].read_text()
    params = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
    kinds = []
    for decl in params.split(","):
        decl = decl.strip()
        kinds.append("p" if "*" in decl else decl.split()[0])
    want = {"p": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}
    assert [want[k] for k in kinds] == argtypes


def test_n_split_follows_from_the_shapes_alone():
    """The chunk, and so the split grid, is a function of (B, K, S), which
    the host knows: zamba2's step takes 2048-key chunks (16 of them, 512
    blocks of 4 kv heads), a small batch keeps 512-key chunks to fill the
    card."""
    import inspect
    for fn in (fd_t.chunk_size, fd_t.n_split, fd_t.launch_grid):
        assert list(inspect.signature(fn).parameters) == ["B", "K", "S"]
    assert fd_t.chunk_size(4, 32, 32768) == 2048
    assert fd_t.launch_grid(4, 32, 32768) == ((16, 8, 4), (32, 4))
    assert fd_t.chunk_size(1, 2, 32768) == 512
    assert fd_t.launch_grid(2, 2, 4097) == ((9, 1, 2), (2, 2))
    assert fd_t.n_split(3, 2, 1) == 1
    for B, K, S in ((4, 32, 32768), (1, 8, 32768), (2, 2, 4097)):
        chunk = fd_t.chunk_size(B, K, S)
        assert chunk in fd_t.CHUNKS and chunk % fd_t._WARPS == 0
        assert (fd_t.n_split(B, K, S) - 1) * chunk < S <= (
            fd_t.n_split(B, K, S) * chunk)


def test_wrapper_never_waits_for_pos():
    """The wrapper reads pos only as a pointer: no .item(), .cpu(), .max(),
    .tolist() or int() of it, which would wait for the card each layer.
    ``flash_decode`` hands pos to its split pass, ``flash_decode_partials``,
    which reads it."""
    import inspect
    src = inspect.getsource(fd_t.flash_decode) + inspect.getsource(
        fd_t.flash_decode_partials)
    for call in ("pos.item", "pos.cpu", "pos.max", "pos.tolist", "int(pos",
                 "pos.numpy"):
        assert call not in src, call
    assert "pos.data_ptr()" in src


# ---------------------------------------------------------------------------
# the split and combine passes' algebra, in plain torch
# ---------------------------------------------------------------------------

def _split_combine(q, k, v, pos, *, chunk, softcap=0.0, window=0):
    """The kernels' arithmetic on the host: each chunk of ``chunk`` keys of
    each (b, kv head) reduced to its partial (m, l, acc[G, hd]) over its
    visible keys, an empty chunk to (-1e30, 0, 0); the partials merged in
    chunk order with weights exp(m_c - max m); out = acc / max(l, 1e-30).
    All in f32."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    out = torch.empty(B, H, hd)
    for b in range(B):
        p = int(pos[b])
        hi = min(p, S - 1)
        lo = max(0, p - window + 1) if window > 0 else 0
        for kh in range(K):
            qg = q[b, kh * G:(kh + 1) * G].float()
            parts = []
            for c0 in range(0, S, chunk):
                c_lo, c_hi = max(lo, c0), min(hi, c0 + chunk - 1)
                if c_lo > c_hi:
                    parts.append((torch.full((G,), NEG_INF), torch.zeros(G),
                                  torch.zeros(G, hd)))
                    continue
                s = qg @ k[b, c_lo:c_hi + 1, kh].float().T * hd ** -0.5
                if softcap > 0:
                    s = torch.tanh(s / softcap) * softcap
                m = s.amax(-1)
                e = torch.exp(s - m[:, None])
                parts.append((m, e.sum(-1),
                              e @ v[b, c_lo:c_hi + 1, kh].float()))
            m_all = torch.stack([m for m, _, _ in parts]).amax(0)
            l_sum, acc = torch.zeros(G), torch.zeros(G, hd)
            for m, l, a in parts:
                w = torch.exp(m - m_all)
                l_sum = l_sum + w * l
                acc = acc + w[:, None] * a
            out[b, kh * G:(kh + 1) * G] = acc / l_sum.clamp_min(1e-30)[:, None]
    return out


NEG_INF = -1e30
# (B, H, K, S, hd, chunk, options): chunks small enough that most of them
# are empty or partly visible, pos 0 in every case's last row
SPLIT_CASES = [
    (3, 8, 2, 77, 64, 16, {}),
    (2, 4, 4, 256, 112, 32, {"window": 40}),
    (2, 8, 2, 300, 32, 64, {"window": 100, "softcap": 30.0}),
    (3, 2, 1, 128, 128, 512, {"softcap": 20.0}),
    (2, 4, 2, 1000, 64, None, {"window": 7}),   # the wrapper's own chunk
]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "B{}H{}K{}S{}hd{}chunk{}".format(*c[:6])
                         + "".join(f"-{k}{v}" for k, v in c[6].items()))
def test_split_combine_matches_the_references(case):
    """The split-and-combine algebra, held to the port's plain version, the
    JAX package's oracle and its Pallas kernel (interpret mode) within the
    f32 tolerance of this file."""
    B, H, K, S, hd, chunk, kw = case
    xs = _inputs(B, H, K, S, hd, seed=S + hd + 1)
    got = _split_combine(*map(torch.from_numpy, xs),
                         chunk=chunk or fd_t.chunk_size(B, K, S), **kw)
    np.testing.assert_allclose(got.numpy(), _port(*xs, **kw), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), _jax(ref_j, *xs, **kw), rtol=0,
                               atol=ATOL)
    if S % 64 == 0:
        ker = _jax(fd_pallas, *xs, block_s=64, interpret=True, **kw)
        np.testing.assert_allclose(got.numpy(), ker, rtol=0, atol=ATOL)
