"""The port's MoE, MLA and cross-attention layers against the JAX package on
the CPU.

The same seeded numpy inputs and weights go through ``repro.models.moe`` /
``repro.models.layers`` and their ports, in f32.

Tolerances, stated with their reasons:
- ``moe_ffn`` output and aux loss: 1e-5 absolute (outputs of magnitude
  ~1). The same routing in both packages (checked index for index), then
  the same f32 products; XLA and PyTorch round their matmuls and sums
  differently in the last bits.
- routing indices: equal, ties included. Each routing check states the
  smallest gap between a token's k-th and (k+1)-th router probability, so
  a near-tie that both packages happen to break alike is visible.
- MLA prefill and decode, cross-attention: 1e-5 absolute (outputs of
  magnitude ~1; layers of a few f32 matmuls and a softmax), decode's
  latent cache the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as L_j
from repro.models import moe as moe_j
from repro_torch.models import layers as L_t
from repro_torch.models import moe as moe_t

ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jnp(tree):
    return {k: _jnp(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(rng, D, E, F, n_shared, router=None):
    p = {"router": (router if router is not None
                    else _normal(rng, D, E, scale=D ** -0.5)),
         "wg": _normal(rng, E, D, F, scale=D ** -0.5),
         "wu": _normal(rng, E, D, F, scale=D ** -0.5),
         "wd": _normal(rng, E, F, D, scale=F ** -0.5)}
    if n_shared:
        p["shared"] = {"wg": _normal(rng, D, F * n_shared, scale=D ** -0.5),
                       "wu": _normal(rng, D, F * n_shared, scale=D ** -0.5),
                       "wd": _normal(rng, F * n_shared, D,
                                     scale=(F * n_shared) ** -0.5)}
    return p


def _routing_both(x, router, k):
    """(JAX indices, port indices, port probabilities) of every token."""
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("td,de->te", jnp.asarray(xf),
                                      jnp.asarray(router)), axis=-1)
    _, idx_j = jax.lax.top_k(probs, k)
    probs_t, _, idx_t = moe_t.route(torch.from_numpy(xf),
                                    torch.from_numpy(router), k)
    return np.asarray(idx_j), idx_t.numpy(), probs_t


def _kth_gap(probs, k) -> float:
    """The smallest gap between a token's k-th and (k+1)-th probability."""
    top = torch.sort(probs, dim=-1, descending=True).values
    return float((top[:, k - 1] - top[:, k]).min())


def _tied_router(rng, D):
    """Columns 0-2 equal, column 3 apart: a token whose shared column wins
    ties three experts for its two slots (a tie at the k-th / (k+1)-th
    place); one whose column 3 wins ties its second slot three ways."""
    a, b = _normal(rng, D, 1, scale=D ** -0.5), _normal(rng, D, 1,
                                                       scale=D ** -0.5)
    return np.concatenate([a, a, a, b], axis=1)


@pytest.mark.parametrize("case", ["g1", "g2", "drop", "ties"])
def test_moe_ffn_matches(case):
    """Output and aux loss of ``moe_ffn`` at one and two dispatch groups,
    with heavy capacity drops (cf 0.5) and with exact ties in the router;
    the routing index for index."""
    rng = _rng({"g1": 0, "g2": 1, "drop": 2, "ties": 3}[case])
    D, F = 64, 32
    E, k, n_shared = (4, 2, 1) if case == "ties" else (8, 2, 1)
    router = _tied_router(rng, D) if case == "ties" else None
    p = _moe_params(rng, D, E, F, n_shared, router)
    x = _normal(rng, 2, 12, D)
    cf = 0.5 if case == "drop" else 1.25
    groups = 2 if case == "g2" else 1

    idx_j, idx_t, probs = _routing_both(x, p["router"], k)
    gap = _kth_gap(probs, k)
    np.testing.assert_array_equal(
        idx_t, idx_j, err_msg=f"routing differs; smallest k/k+1 gap {gap}")
    if case == "ties":
        assert gap == 0.0 and (idx_t[:, 0] == 0).any() \
            and (idx_t[:, 0] == 3).any(), "the router made no ties"

    try:
        moe_j.set_dispatch_groups(groups)
        moe_t.set_dispatch_groups(groups)
        y_j, aux_j = moe_j.moe_ffn(_jnp(p), jnp.asarray(x), k, cf)
        y_t, aux_t = moe_t.moe_ffn(_torch(p), torch.from_numpy(x), k, cf)
    finally:
        moe_j.set_dispatch_groups(1)
        moe_t.set_dispatch_groups(1)
    T = x.shape[0] * x.shape[1]
    cap = max(int(cf * (T // groups) * k / E), 1)
    assert cap * E * groups < T * k or case != "drop", "no slot dropped"
    assert y_t.shape == x.shape and aux_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=ATOL, err_msg=f"k/k+1 gap {gap}")
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=0, atol=ATOL)


def test_dispatch_groups_fall_back_to_one_when_they_do_not_divide():
    """G = 5 does not divide 2 x 12 tokens: both packages use one group."""
    rng = _rng(4)
    p = _moe_params(rng, 32, 4, 16, 0)
    x = _normal(rng, 2, 12, 32)
    try:
        moe_j.set_dispatch_groups(5)
        moe_t.set_dispatch_groups(5)
        y_j, aux_j = moe_j.moe_ffn(_jnp(p), jnp.asarray(x), 2)
        y_t, aux_t = moe_t.moe_ffn(_torch(p), torch.from_numpy(x), 2)
    finally:
        moe_j.set_dispatch_groups(1)
        moe_t.set_dispatch_groups(1)
    y_1, aux_1 = moe_t.moe_ffn(_torch(p), torch.from_numpy(x), 2)
    assert torch.equal(y_t, y_1) and torch.equal(aux_t, aux_1)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=ATOL)


def test_route_breaks_ties_by_the_lower_index():
    """``torch.topk`` is free to order ties; ``route`` takes the reference's
    order: [0.25] * 4 picks experts 0 and 1."""
    x = np.zeros((3, 8), np.float32)
    router = np.zeros((8, 4), np.float32)
    probs, gate, idx = moe_t.route(torch.from_numpy(x),
                                   torch.from_numpy(router), 2)
    _, idx_j = jax.lax.top_k(jnp.full((3, 4), 0.25), 2)
    assert idx.tolist() == [[0, 1]] * 3 == np.asarray(idx_j).tolist()
    assert torch.equal(gate, torch.full((3, 2), 0.25))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_module_names_and_router_dtype(dtype):
    """``MoE``'s state names are ``init_moe``'s leaves; the router is f32 in
    a bf16 layer, as in the reference."""
    mod = moe_t.MoE(torch.Generator().manual_seed(0), 32, 4, 16, 2, dtype,
                    "cpu")
    p_j = jax.eval_shape(lambda: moe_j.init_moe(
        jax.random.PRNGKey(0), 32, 4, 16, 2,
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
    want = {".".join(str(k.key) for k in path): (leaf.shape, str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(p_j)[0]}
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[1])
           for k, v in mod.state_dict().items()}
    assert got == want
    assert not any(p.requires_grad for p in mod.parameters())


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_params(rng, D, dims):
    H, hd, r, rh = (dims.n_heads, dims.head_dim, dims.kv_lora_rank,
                    dims.rope_head_dim)
    qr = dims.q_lora_rank or D
    return {"wq_a": _normal(rng, D, qr, scale=D ** -0.5),
            "wq_b": _normal(rng, qr, H, hd + rh, scale=qr ** -0.5),
            "wkv_a": _normal(rng, D, r + rh, scale=D ** -0.5),
            "wkv_b": _normal(rng, r, H, 2 * hd, scale=r ** -0.5),
            "wo": _normal(rng, H, hd, D, scale=(H * hd) ** -0.5),
            "q_norm": _normal(rng, qr, scale=0.1),
            "kv_norm": _normal(rng, r, scale=0.1)}


def _mla_dims(q_lora_rank):
    args = dict(n_heads=4, head_dim=16, kv_lora_rank=32,
                q_lora_rank=q_lora_rank, rope_head_dim=8, rope_theta=1e4)
    return L_j.MLADims(**args), L_t.MLADims(**args)


@pytest.mark.parametrize("q_lora_rank", [48, 0])
def test_mla_attention_matches(q_lora_rank):
    """The expanded prefill form, S 20; q_lora_rank 0 projects q from D."""
    rng = _rng(10 + q_lora_rank)
    D, S = 64, 20
    dims_j, dims_t = _mla_dims(q_lora_rank)
    p = _mla_params(rng, D, dims_j)
    x = _normal(rng, 2, S, D)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    ref = L_j.mla_attention(_jnp(p), jnp.asarray(x), dims_j,
                            jnp.asarray(pos))
    got = L_t.mla_attention(_torch(p), torch.from_numpy(x), dims_t,
                            torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("pos", [[0, 0], [9, 3], [23, 17]])
def test_mla_attention_decode_matches(pos):
    """The absorbed decode form from a seeded latent cache: the output and
    the cache, which the port writes in place at ``pos``."""
    rng = _rng(20 + sum(pos))
    D, S = 64, 24
    dims_j, dims_t = _mla_dims(48)
    p = _mla_params(rng, D, dims_j)
    x = _normal(rng, 2, 1, D)
    cache = _normal(rng, 2, S, 32 + 8)
    pos = np.array(pos, np.int32)
    out_j, cache_j = L_j.mla_attention_decode(
        _jnp(p), jnp.asarray(x), dims_j, jnp.asarray(cache), jnp.asarray(pos))
    cache_t = torch.from_numpy(cache.copy())
    out_t, ret = L_t.mla_attention_decode(
        _torch(p), torch.from_numpy(x), dims_t, cache_t, torch.from_numpy(pos))
    assert ret is cache_t
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(cache_t.numpy(), np.asarray(cache_j), rtol=0,
                               atol=ATOL)
    untouched = np.ones(S, bool)
    for b, i in enumerate(pos):
        untouched[:] = True
        untouched[i] = False
        np.testing.assert_array_equal(cache_t[b, untouched].numpy(),
                                      cache[b, untouched])


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,K,Sk", [(4, 4, 7), (4, 2, 13), (4, 4, 0)])
def test_cross_attention_matches(H, K, Sk):
    """Sq 9 against Sk memory frames, no rope and no mask; Sk 0 is the
    serving engine's empty memory, which gives zeros in both packages."""
    rng = _rng(30 + H + K + Sk)
    D, hd = 64, 16
    p = {"wq": _normal(rng, D, H, hd, scale=D ** -0.5),
         "wk": _normal(rng, D, K, hd, scale=D ** -0.5),
         "wv": _normal(rng, D, K, hd, scale=D ** -0.5),
         "wo": _normal(rng, H, hd, D, scale=(H * hd) ** -0.5)}
    x = _normal(rng, 2, 9, D)
    mem = _normal(rng, 2, Sk, D)
    ref = L_j.cross_attention(_jnp(p), jnp.asarray(x), jnp.asarray(mem),
                              L_j.AttnDims(H, K, hd))
    got = L_t.cross_attention(_torch(p), torch.from_numpy(x),
                              torch.from_numpy(mem), L_t.AttnDims(H, K, hd))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    if Sk == 0:
        assert not got.any()
