"""The port's model substrate against the JAX package on the CPU.

Layers (``rms_norm``, ``apply_rope``, ``causal_window_mask``, the CPU
``attention`` path and ``mlp``) and whole ``Model.forward`` passes are fed
the same seeded numpy inputs and, for the models, the same weights: the JAX
``Model.init`` tree carried across by ``carry.model_params_from_numpy``.

Tolerances, stated with their reasons:
- layers in f32: 2e-6 absolute. The same f32 formulas; matmul and
  transcendental kernels of XLA and PyTorch round differently in the last
  bits.
- f32 model logits: 1e-4 absolute (logits of magnitude ~5). Those last-bit
  differences grow through the layers; measured at under 2e-5.
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
from repro_torch.carry import model_params_from_numpy
from repro_torch.models import layers as L_t
from repro_torch.models.transformer import Model

LAYER_ATOL = 2e-6
LOGIT_ATOL = 1e-4
BF16_LOGIT_ATOL = 0.25

PORTED = ("qwen2.5-3b", "granite-8b", "gemma2-2b", "llava-next-34b",
          "waste-pipeline")


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


def _forward_both(arch, dtype="float32", S=48, seed=0):
    cj, ct = _configs(arch, dtype)
    mj = Model_j(cj)
    pj = mj.init(jax.random.PRNGKey(seed))
    mt = Model(ct, device="cpu")
    mt.load_state_dict(model_params_from_numpy(ct, jax.device_get(pj),
                                               device="cpu"))
    rng = _rng(seed + 1)
    batch = {"tokens": rng.integers(0, ct.vocab_size, (2, S)).astype(
        np.int32)}
    if ct.frontend == "vision":
        batch["media"] = _normal(rng, 2, ct.n_media_tokens, ct.d_model)
    ref, _ = jax.jit(mj.forward)(pj, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    got, aux = mt({k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(aux) == 0.0
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_with_carried_weights(arch):
    """Reduced configs, and the full waste-pipeline, at f32; S=48 text
    tokens, so gemma2's reduced window of 16 bites."""
    ref, got = _forward_both(arch)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_ATOL)


def test_waste_pipeline_bf16_forward_matches():
    ref, got = _forward_both("waste-pipeline", dtype="bfloat16", S=64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_LOGIT_ATOL)


def test_state_names_mirror_the_jax_leaves():
    for arch in PORTED:
        cj, ct = _configs(arch)
        pj = jax.eval_shape(Model_j(cj).init, jax.random.PRNGKey(0))
        sd = Model(ct, device="cpu").state_dict()
        want = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(pj)[0]:
            keys = [k.key for k in path]
            if keys[0] == "stack":
                for i in range(ct.n_layers):
                    want[".".join(["layers", str(i), *keys[1:]])] = \
                        leaf.shape[1:]
            else:
                want[".".join(keys)] = leaf.shape
        assert {k: tuple(v.shape) for k, v in sd.items()} == \
            {k: tuple(v) for k, v in want.items()}, arch
        assert all(v.dtype == getattr(torch, ct.dtype) for v in sd.values())


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


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b",
                                  "deepseek-v2-236b", "kimi-k2-1t-a32b",
                                  "seamless-m4t-medium"])
def test_families_not_ported_raise(arch):
    cfg = configs_t.reduced(configs_t.get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg, device="cpu")


def test_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = configs_t.reduced(configs_t.get_config("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
