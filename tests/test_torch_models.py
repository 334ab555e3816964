"""The port's model substrate against the JAX package on the CPU.

Layers (``rms_norm``, ``apply_rope``, ``causal_window_mask``, the CPU
``attention`` path and ``mlp``), whole ``Model.forward`` passes and
``Model.decode_step``s are fed the same seeded numpy inputs and, for the
models, the same weights: the JAX ``Model.init`` tree carried across by
``carry.model_params_from_numpy``; decode starts both packages from the
same mid-run state (``carry.decode_state_from_numpy``).

Tolerances, stated with their reasons:
- layers in f32: 2e-6 absolute. The same f32 formulas; matmul and
  transcendental kernels of XLA and PyTorch round differently in the last
  bits.
- f32 model logits: 1e-4 absolute (logits of magnitude ~5). Those last-bit
  differences grow through the layers; measured at under 2e-5. The MoE
  aux loss (magnitude ~1, a sum over the MoE layers): 1e-6 absolute; the
  same routing in both packages, so it differs only in the last bits of
  the router's softmax and means.
- decode: logits 1e-4 absolute, as the forward; every state leaf 1e-5
  absolute (caches, conv buffers and recurrent states of magnitude ~1,
  measured under 2e-7 after three steps).
- the full waste-pipeline in its own bf16: 0.25 absolute on logits of
  magnitude ~5 (measured: 0.10). Both frameworks round every matmul output and every
  activation to bf16 (8 bits of mantissa), at different places inside the
  fused ops; one bf16 ulp at magnitude 4 is 0.03 and 8 layers compound it.

The copies of ``models/config.py``, ``configs/`` and ``core/wps.py`` are
pinned to their originals.
"""

import dataclasses
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as configs_j
import repro.core.wps as wps_j
import repro.models.config as config_j
from repro.models import layers as L_j
from repro.models.transformer import Model as Model_j
import repro_torch.configs as configs_t
import repro_torch.core.wps as wps_t
import repro_torch.models.config as config_t
from repro_torch.carry import decode_state_from_numpy
from repro_torch.carry import model_params_from_numpy
from repro_torch.models import layers as L_t
from repro_torch.models.transformer import Model

LAYER_ATOL = 2e-6
LOGIT_ATOL = 1e-4
BF16_LOGIT_ATOL = 0.25

AUX_ATOL = 1e-6

PORTED = configs_j.ARCHS
MOE = ("deepseek-v2-236b", "kimi-k2-1t-a32b", "moonshot-v1-16b-a3b")
DECODE = ("qwen2.5-3b", "zamba2-7b", "falcon-mamba-7b", *MOE,
          "seamless-m4t-medium")


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the copies are pinned
# ---------------------------------------------------------------------------

def _port_source(module) -> str:
    return inspect.getsource(module).replace("repro_torch", "repro")


@pytest.mark.parametrize("module_pair", [
    (config_t, config_j), (wps_t, wps_j), (configs_t, configs_j),
], ids=["models.config", "core.wps", "configs"])
def test_copied_module_matches_its_original(module_pair):
    port, orig = module_pair
    assert _port_source(port) == inspect.getsource(orig)


@pytest.mark.parametrize("arch", configs_j.ARCHS)
def test_config_and_reduced_match(arch):
    assert configs_t.ARCHS == configs_j.ARCHS
    full_t, full_j = configs_t.get_config(arch), configs_j.get_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert (dataclasses.asdict(configs_t.reduced(full_t))
            == dataclasses.asdict(configs_j.reduced(full_j)))
    assert inspect.getmodule(full_t.__class__) is config_t
    name = configs_j._MODULES[arch]
    src_t = inspect.getsource(
        importlib.import_module(f"repro_torch.configs.{name}"))
    src_j = inspect.getsource(importlib.import_module(f"repro.configs.{name}"))
    assert src_t.replace("repro_torch", "repro") == src_j


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_matches():
    rng = _rng(0)
    x, scale = _normal(rng, 2, 7, 64), _normal(rng, 64, scale=0.1)
    ref = np.asarray(L_j.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    got = L_t.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=LAYER_ATOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches(theta):
    rng = _rng(1)
    x = _normal(rng, 2, 45, 3, 32)
    pos = np.broadcast_to(np.arange(45, dtype=np.int32), (2, 45)).copy()
    ref = np.asarray(L_j.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = L_t.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("window", [-1, 0, 1, 4, 16])
def test_causal_window_mask_matches(window):
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    ref = np.asarray(L_j.causal_window_mask(jnp.asarray(pos), jnp.asarray(pos),
                                            jnp.int32(window)))
    got = L_t.causal_window_mask(torch.from_numpy(pos), torch.from_numpy(pos),
                                 window)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def _attn_params(rng, D, H, K, hd, bias):
    p = {"wq": _normal(rng, D, H, hd, scale=D ** -0.5),
         "wk": _normal(rng, D, K, hd, scale=D ** -0.5),
         "wv": _normal(rng, D, K, hd, scale=D ** -0.5),
         "wo": _normal(rng, H, hd, D, scale=(H * hd) ** -0.5)}
    if bias:
        p.update(bq=_normal(rng, H, hd), bk=_normal(rng, K, hd),
                 bv=_normal(rng, K, hd))
    return p


@pytest.mark.parametrize("H,K,window,cap,bias", [
    (4, 4, -1, 0.0, False),
    (4, 2, 16, 50.0, False),     # gemma2's local layer, reduced
    (8, 2, -1, 0.0, True),       # qwen2.5's GQA with qkv bias
    (4, 1, 8, 20.0, True),       # MQA
])
def test_attention_cpu_path_matches(H, K, window, cap, bias):
    rng = _rng(H * 10 + K)
    D, hd, S = 64, 32, 41
    p = _attn_params(rng, D, H, K, hd, bias)
    x = _normal(rng, 2, S, D)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    dims_j = L_j.AttnDims(H, K, hd, 1e4, cap)
    dims_t = L_t.AttnDims(H, K, hd, 1e4, cap)
    ref = np.asarray(L_j.attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), dims_j,
        jnp.asarray(pos), jnp.int32(window)))
    got = L_t.attention({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), dims_t, torch.from_numpy(pos),
                        window)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=LAYER_ATOL)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_mlp_matches(act):
    rng = _rng(3)
    D, F = 64, 160
    p = {"wg": _normal(rng, D, F, scale=D ** -0.5),
         "wu": _normal(rng, D, F, scale=D ** -0.5),
         "wd": _normal(rng, F, D, scale=F ** -0.5)}
    x = _normal(rng, 2, 9, D)
    ref = np.asarray(L_j.mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), act))
    got = L_t.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                  torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=LAYER_ATOL)


# ---------------------------------------------------------------------------
# whole forward passes with carried weights
# ---------------------------------------------------------------------------

def _configs(arch, dtype="float32"):
    if arch == "waste-pipeline":
        cj, ct = configs_j.get_config(arch), configs_t.get_config(arch)
        return (dataclasses.replace(cj, dtype=dtype),
                dataclasses.replace(ct, dtype=dtype))
    return configs_j.reduced(configs_j.get_config(arch)), configs_t.reduced(
        configs_t.get_config(arch))


def _models(arch, dtype="float32", seed=0):
    """Both packages' models of ``arch`` holding the JAX ``init`` weights."""
    cj, ct = _configs(arch, dtype)
    mj = Model_j(cj)
    pj = mj.init(jax.random.PRNGKey(seed))
    mt = Model(ct, device="cpu")
    mt.load_state_dict(model_params_from_numpy(ct, jax.device_get(pj),
                                               device="cpu"))
    return mj, pj, mt, ct


def _forward_both(arch, dtype="float32", S=48, seed=0):
    """Both packages' logits, and the aux losses held within AUX_ATOL (0
    without MoE). The encoder-decoder's media: S // 4 audio frames."""
    mj, pj, mt, ct = _models(arch, dtype, seed)
    rng = _rng(seed + 1)
    batch = {"tokens": rng.integers(0, ct.vocab_size, (2, S)).astype(
        np.int32)}
    if ct.frontend == "vision":
        batch["media"] = _normal(rng, 2, ct.n_media_tokens, ct.d_model)
    elif ct.is_encoder_decoder:
        batch["media"] = _normal(rng, 2, S // 4, ct.d_model)
    ref, aux_j = jax.jit(mj.forward)(pj, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    got, aux = mt({k: torch.from_numpy(v) for k, v in batch.items()})
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert (float(aux) > 0) == ct.uses_moe
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=0,
                               atol=AUX_ATOL)
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_with_carried_weights(arch):
    """Every config reduced, and the full waste-pipeline, at f32; S=48 text
    tokens, so gemma2's reduced window of 16 bites; the MoE configs' aux
    loss within AUX_ATOL."""
    ref, got = _forward_both(arch)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_ATOL)


def test_waste_pipeline_bf16_forward_matches():
    ref, got = _forward_both("waste-pipeline", dtype="bfloat16", S=64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_LOGIT_ATOL)


_STACKS = {"stack": "layers", "dense_stack": "dense_layers",
           "enc_stack": "enc_layers", "dec_stack": "dec_layers"}


def _port_names(keys, shape):
    """The port's names (and shapes) of one JAX leaf: each stacked axis of
    ``stack``, ``dense_stack``, ``enc_stack``, ``dec_stack``,
    ``ssm_stack``, ``groups`` and ``tail`` becomes a list index."""
    top, rest = keys[0], keys[1:]
    n_axes = {**dict.fromkeys(_STACKS, 1), "ssm_stack": 1, "tail": 1,
              "groups": 2}.get(top, 0)
    name = _STACKS.get(top, top)
    idx = [[]]
    for n in shape[:n_axes]:
        idx = [i + [str(j)] for i in idx for j in range(n)]
    return {".".join([name, *i, *rest]): tuple(shape[n_axes:]) for i in idx}


def test_state_names_mirror_the_jax_leaves():
    for arch in PORTED:
        cj, ct = _configs(arch)
        pj = jax.eval_shape(Model_j(cj).init, jax.random.PRNGKey(0))
        sd = Model(ct, device="cpu").state_dict()
        want = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(pj)[0]:
            want.update(_port_names([k.key for k in path], leaf.shape))
        assert {k: tuple(v.shape) for k, v in sd.items()} == want, arch
        assert all(v.dtype == getattr(torch, ct.dtype) for v in sd.values())


@pytest.mark.parametrize("arch", ["zamba2-7b", "falcon-mamba-7b"])
def test_f32_ssm_leaves_keep_f32_in_a_bf16_model(arch):
    """In a bf16 model the SSM's ``D``, ``dt_bias``, ``A_log`` and
    ``D_head`` are f32, in the JAX tree, in the port's own ``init`` and
    through the carry; every other leaf is bf16."""
    cj, ct = (dataclasses.replace(c, dtype="bfloat16")
              for c in _configs(arch))
    pj = jax.device_get(Model_j(cj).init(jax.random.PRNGKey(0)))
    carried = model_params_from_numpy(ct, pj, device="cpu")
    own = Model(ct, device="cpu").state_dict()
    assert set(carried) == set(own)
    f32 = {k for k in own if k.rsplit(".", 1)[-1] in
           ("D", "dt_bias", "A_log", "D_head")}
    assert f32
    for k, v in carried.items():
        want = torch.float32 if k in f32 else torch.bfloat16
        assert v.dtype == want and own[k].dtype == want, k
    flat = {".".join(str(p.key) for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(pj)[0]}
    assert {str(v.dtype) for k, v in flat.items()
            if k.rsplit(".", 1)[-1] in ("D", "dt_bias", "A_log",
                                        "D_head")} == {"float32"}


@pytest.mark.parametrize("arch", MOE)
def test_f32_router_keeps_f32_in_a_bf16_model(arch):
    """In a bf16 MoE model every MoE layer's ``router`` is f32, in the JAX
    tree, in the port's own ``init`` and through the carry; every other
    leaf is bf16."""
    cj, ct = (dataclasses.replace(c, dtype="bfloat16")
              for c in _configs(arch))
    pj = jax.device_get(Model_j(cj).init(jax.random.PRNGKey(0)))
    carried = model_params_from_numpy(ct, pj, device="cpu")
    own = Model(ct, device="cpu").state_dict()
    assert set(carried) == set(own)
    routers = {k for k in own if k.endswith(".moe.router")}
    assert len(routers) == ct.n_layers - ct.first_dense_layers
    for k, v in carried.items():
        want = torch.float32 if k in routers else torch.bfloat16
        assert v.dtype == want and own[k].dtype == want, k
    assert pj["stack"]["moe"]["router"].dtype == np.float32


def test_carry_rejects_a_wrong_layer_count():
    cj, ct = _configs("qwen2.5-3b")
    pj = jax.device_get(Model_j(cj).init(jax.random.PRNGKey(0)))
    pj["stack"]["attn"]["wq"] = pj["stack"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="layers"):
        model_params_from_numpy(ct, pj, device="cpu")


def test_init_is_seeded():
    cfg = configs_t.reduced(configs_t.get_config("qwen2.5-3b"))
    a = Model(cfg, seed=3, device="cpu").state_dict()
    b = Model(cfg, seed=0, device="cpu").init(3).state_dict()
    c = Model(cfg, seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])


def test_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = configs_t.reduced(configs_t.get_config("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _mid_run_state(mj, B, S, seed):
    """A JAX decode state with every leaf seeded: caches, conv buffers and
    recurrent states non-zero, ``pos`` > 0 and different per row."""
    rng = _rng(seed)
    state = jax.device_get(mj.init_decode_state(B, S))
    out = {}
    for k, v in state.items():
        if k == "pos":
            out[k] = np.array([S // 2, S // 3 + 1][:B], np.int32)
        else:
            out[k] = _normal(rng, *v.shape, scale=0.5 if k.startswith("h")
                             else 1.0).astype(v.dtype)
    return out


@pytest.mark.parametrize("arch", DECODE)
def test_decode_step_matches_from_a_mid_run_state(arch):
    """Three steps from the same carried mid-run state: the logits and every
    state leaf after each, and the state's keys, shapes and dtypes."""
    mj, pj, mt, ct = _models(arch)
    sj = _mid_run_state(mj, 2, 24, seed=5)
    st = decode_state_from_numpy(ct, sj, device="cpu")
    sj = {k: jnp.asarray(v) for k, v in sj.items()}
    step_j = jax.jit(mj.decode_step)
    rng = _rng(6)
    for _ in range(3):
        tokens = rng.integers(0, ct.vocab_size, 2).astype(np.int32)
        lj, sj = step_j(pj, sj, jnp.asarray(tokens))
        lt, st = mt.decode_step(st, torch.from_numpy(tokens))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=LOGIT_ATOL)
        assert set(st) == set(sj)
        for k, v in sj.items():
            assert tuple(st[k].shape) == v.shape, k
            assert str(st[k].dtype).split(".")[1] == str(v.dtype), k
            np.testing.assert_allclose(st[k].numpy(), np.asarray(v),
                                       rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", DECODE)
def test_init_decode_state_matches(arch):
    mj, _, mt, _ = _models(arch)
    want = jax.eval_shape(lambda: mj.init_decode_state(3, 40))
    got = mt.init_decode_state(3, 40)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    assert all(not v.any() for v in got.values())


@pytest.mark.parametrize("arch", DECODE[:3])
def test_decode_matches_forward_prefix(arch):
    """Decoding a sequence token by token from an empty state gives the
    forward pass's logits at every position (S = 16, one SSM chunk)."""
    _, _, mt, ct = _models(arch)
    S = 16
    tokens = torch.from_numpy(
        _rng(7).integers(0, ct.vocab_size, (2, S)).astype(np.int32))
    full, _ = mt({"tokens": tokens})
    state = mt.init_decode_state(2, S)
    for t in range(S):
        logits, state = mt.decode_step(state, tokens[:, t])
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=0, atol=LOGIT_ATOL)
    assert state["pos"].tolist() == [S, S]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "moonshot-v1-16b-a3b"])
def test_moe_decode_matches_forward_prefix(arch):
    """As above for the MoE configs, at ``capacity_factor = n_experts /
    top_k``: a forward of T tokens then gives each expert T slots, and a
    decode step of B tokens B, so no slot drops in either and the two
    route alike. For deepseek it holds MLA's absorbed decode form to its
    expanded forward form. With the default factor a decode step of B 2
    has one slot an expert and drops tokens the forward keeps, so there
    decode is held to the reference's ``decode_step`` from the same state
    (``test_decode_step_matches_from_a_mid_run_state``)."""
    cfg = configs_t.reduced(configs_t.get_config(arch))
    cfg = dataclasses.replace(cfg,
                              capacity_factor=cfg.n_experts / cfg.top_k)
    mt = Model(cfg, seed=2, device="cpu")
    S = 16
    tokens = torch.from_numpy(
        _rng(8).integers(0, cfg.vocab_size, (2, S)).astype(np.int32))
    full, _ = mt({"tokens": tokens})
    state = mt.init_decode_state(2, S)
    for t in range(S):
        logits, state = mt.decode_step(state, tokens[:, t])
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=0, atol=LOGIT_ATOL)
    assert state["pos"].tolist() == [S, S]


@pytest.mark.parametrize("arch", ["zamba2-7b", "falcon-mamba-7b"])
def test_unaligned_forward_raises_in_both_packages(arch):
    """S = 20 is not a multiple of the reduced configs' SSM chunk of 16:
    the JAX package's chunked scan asserts, and the port raises."""
    mj, pj, mt, ct = _models(arch)
    tokens = np.zeros((1, 20), np.int32)
    with pytest.raises(AssertionError):
        mj.forward(pj, {"tokens": jnp.asarray(tokens)})
    with pytest.raises(ValueError, match="chunk"):
        mt({"tokens": torch.from_numpy(tokens)})
