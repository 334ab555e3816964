"""The port's flash attention against the JAX package on the CPU.

The port's ``attention_ref`` (the CUDA kernel's plain version, the path
CPU tensors take) is held to the JAX package's ``attention_ref`` and to its
Pallas kernel run in interpret mode, at the shapes the JAX package's own
kernel tests sweep (GQA, MQA, sliding window, softcap, non-causal), and to
the JAX ``attention_ref`` alone at ragged sequence lengths, which the Pallas
kernel's block tiling does not take. Inputs are seeded numpy, f32.

Tolerance: 1e-5 absolute. Both sides compute the same f32 masked softmax;
their sums run in different orders, which moves outputs of magnitude ~1 by
a few 1e-7.

The CUDA kernel itself cannot run here; ``chip_smoke.py`` holds it to the
plain version on the card. What the CPU can check of it is tested below:
the dispatch, the build recipe and the ctypes signature.
"""

import ctypes
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
from repro_torch.kernels.flash_attention.ops import attention_op
from repro_torch.kernels.flash_attention.ref import attention_ref

ATOL = 1e-5


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


@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=lambda c: "B{}H{}K{}S{}hd{}bq{}bk{}".format(
                             *c[:7]) + "".join(f"-{k}{v}" for k, v in
                                               c[7].items()))
def test_attention_ref_matches_jax_ref_and_pallas_kernel(case):
    B, H, K, S, hd, bq, bk, kw = case
    xs = _inputs(B, H, K, S, hd, seed=S + hd)
    got = _port(xs, **kw)
    ref = np.asarray(attention_ref_j(*map(jnp.asarray, xs), **kw))
    ker = np.asarray(flash_attention_j(*map(jnp.asarray, xs), block_q=bq,
                                       block_k=bk, interpret=True, **kw))
    assert got.shape == (B, H, S, hd) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ker, rtol=0, atol=ATOL)


@pytest.mark.parametrize("S", [37, 173])
@pytest.mark.parametrize("kw", [
    {}, {"window": 8, "softcap": 20.0}, {"causal": False},
    {"causal": False, "window": 16},
], ids=["causal", "window8-softcap20", "bidirectional", "bidirectional-w16"])
def test_attention_ref_ragged_matches_jax_ref(S, kw):
    xs = _inputs(2, 4, 2, S, 32, seed=S)
    got = _port(xs, **kw)
    ref = np.asarray(attention_ref_j(*map(jnp.asarray, xs), **kw))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_attention_ref_keeps_bf16():
    xs = _inputs(1, 2, 1, 37, 64, seed=3)
    q, k, v = (torch.from_numpy(x).bfloat16() for x in xs)
    out = attention_ref(q, k, v, window=8)
    assert out.dtype == torch.bfloat16
    ref = attention_ref(q.float(), k.float(), v.float(), window=8)
    assert torch.equal(out, ref.bfloat16())


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
    """The kernel builds from the package's own source for sm_90a without
    fast math, and the wrapper accepts exactly the head dims the source
    instantiates."""
    srcs = _build._sources("flash_attention")
    assert [p.name for p in srcs] == ["flash_attention.cu"]
    assert srcs[0].is_relative_to(Path(_build.__file__).parent)
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags
    text = srcs[0].read_text()
    built = {int(m) for m in re.findall(r"case (\d+):\s*return launch<T,",
                                        text)}
    assert built == set(fa_t.HEAD_DIMS)
    assert _build._lib_path("flash_attention").parent == _build.BUILD_DIR


def test_ctypes_signature_matches_the_c_entry_point():
    """One ctypes type per parameter of ``flash_attention_launch``, in
    order (ctypes would otherwise pass a pointer as a 32-bit int)."""
    src = _build._sources("flash_attention")[0].read_text()
    params = re.search(r"int flash_attention_launch\(([^)]*)\)",
                       src).group(1)
    kinds = []
    for decl in params.split(","):
        decl = decl.strip()
        kinds.append("p" if "*" in decl else decl.split()[0])
    want = {"p": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}
    assert [want[k] for k in kinds] == fa_t._ARGTYPES
