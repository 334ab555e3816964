"""The port's training substrate against the JAX package on the CPU:
optimizer, data pipeline and checkpoints (the port of
``tests/test_substrate.py``'s optimizer, data and checkpoint cases, plus
parity with ``repro``).

Tolerances, stated with their reasons:
- AdamW on equal gradients and parameters: f32 leaves and moments within
  1e-6 of the leaf's max |value| (measured ≤ 4.7e-7 of it with clipping,
  0 without), the learning rate and grad norm 1e-6 relative. The same
  f32 formulas; XLA may contract a multiply and an add into one rounding,
  and its ``pow`` and reductions round otherwise in the last bit. bf16
  leaves within one bf16 ulp (measured: equal): the f32 update they are
  rounded from may differ in its last bit, which can move the rounding by
  one ulp.
- ``SyntheticCorpus`` batches: equal bit for bit (the same numpy code).
- checkpoints: equal bit for bit, both ways and in bf16.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as configs_j
from repro.checkpoint import restore as restore_j
from repro.checkpoint import save as save_j
from repro.data.pipeline import SyntheticCorpus as Corpus_j
from repro.optim.adamw import AdamWConfig as AdamWConfig_j
from repro.optim.adamw import adamw_init as adamw_init_j
from repro.optim.adamw import adamw_update as adamw_update_j
import repro_torch.configs as configs_t
from repro_torch.carry import (
    BF16_BITS,
    model_params_from_numpy,
    model_params_to_numpy,
    opt_state_from_numpy,
    opt_state_to_numpy,
)
from repro_torch.checkpoint import restore, save
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.kernels.flash_attention import flash_attention as fa_t
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)

ADAM_RTOL = 1e-6


def _assert_close_to_max(got, want):
    """|got - want| within ADAM_RTOL of max |want|, element by element."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ADAM_RTOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

class TestAdamW:
    def _setup(self):
        params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
        grads = {"w": torch.full((4, 4), 0.5), "b": torch.ones((4,))}
        return params, grads

    def test_update_moves_params(self):
        params, grads = self._setup()
        before = {k: v.clone() for k, v in params.items()}
        cfg = AdamWConfig(lr=1e-2, warmup_steps=0)
        opt = adamw_init(params)
        info = adamw_update(cfg, grads, opt, params)
        assert int(opt.step) == 1
        assert not torch.allclose(params["w"], before["w"])
        assert torch.isfinite(info["grad_norm"])

    def test_clipping(self):
        params, _ = self._setup()
        grads = {"w": torch.full((4, 4), 1e6), "b": torch.full((4,), 1e6)}
        cfg = AdamWConfig(lr=1e-2, clip_norm=1.0, warmup_steps=0)
        opt = adamw_init(params)
        adamw_update(cfg, grads, opt, params)
        assert all(torch.isfinite(v).all() for v in params.values())

    def test_schedule_shape(self):
        cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
        lrs = [float(cosine_schedule(cfg, torch.tensor(s))) for s in
               (0, 5, 10, 50, 100)]
        assert lrs[0] == 0.0
        assert lrs[1] == pytest.approx(0.5)
        assert lrs[2] == pytest.approx(1.0)
        assert lrs[3] < 1.0
        assert lrs[4] == pytest.approx(0.1, abs=1e-3)

    @pytest.mark.parametrize("scale", [1e-3, 0.37, 1.0, 42.0, 1e3])
    def test_global_norm_homogeneous(self, scale):
        t = {"a": torch.ones((3, 3)), "b": torch.ones((2,))}
        n1 = float(global_norm(t))
        n2 = float(global_norm({k: v * scale for k, v in t.items()}))
        assert n2 == pytest.approx(n1 * scale, rel=1e-3)

    def test_schedule_matches_the_reference(self):
        from repro.optim.adamw import cosine_schedule as schedule_j

        kw = dict(lr=3e-4, warmup_steps=7, total_steps=60, min_lr_frac=0.1)
        steps = np.arange(0, 70, dtype=np.int32)
        want = np.asarray(schedule_j(AdamWConfig_j(**kw), jnp.asarray(steps)))
        got = cosine_schedule(AdamWConfig(**kw), torch.from_numpy(steps))
        np.testing.assert_allclose(got.numpy(), want, rtol=ADAM_RTOL)


def _adam_case(seed):
    """Parameters (f32 and bf16, as numpy: bf16 as ml_dtypes arrays) and
    two steps' gradients."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((8, 16)).astype(np.float32),
              "e": rng.standard_normal((5, 3)).astype(np.float32),
              "h": rng.standard_normal((64,)).astype(jnp.bfloat16)}
    grads = [{k: (rng.standard_normal(v.shape) * 0.3).astype(v.dtype)
              for k, v in params.items()} for _ in range(2)]
    return params, grads


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("clip_norm", [1.0, 100.0], ids=["clipped", "free"])
def test_adamw_update_matches_the_reference(clip_norm):
    """Two steps of both packages' ``adamw_update`` from the same
    parameters on the same numpy gradients: parameters, moments, lr and
    grad norm after each."""
    params, grads = _adam_case(0)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=clip_norm)
    cfg_j, cfg_t = AdamWConfig_j(**kw), AdamWConfig(**kw)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: _to_torch(v) for k, v in params.items()}
    opt_j, opt_t = adamw_init_j(pj), adamw_init(pt)
    for g in grads:
        pj, opt_j, info_j = adamw_update_j(
            cfg_j, {k: jnp.asarray(v) for k, v in g.items()}, opt_j, pj)
        info = adamw_update(cfg_t, {k: _to_torch(v) for k, v in g.items()},
                            opt_t, pt)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(info[key]), float(info_j[key]),
                                       rtol=ADAM_RTOL)
        assert int(opt_t.step) == int(opt_j.step)
        for k in params:
            for got, want in ((opt_t.mu[k], opt_j.mu[k]),
                              (opt_t.nu[k], opt_j.nu[k])):
                assert got.dtype == torch.float32
                _assert_close_to_max(got.numpy(), want)
            want = np.asarray(pj[k]).astype(np.float32)
            got = pt[k].float().numpy()
            if k == "h":
                assert pt[k].dtype == torch.bfloat16
                ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
                assert (np.abs(got - want) <= ulp).all()
            else:
                _assert_close_to_max(got, want)


def test_missing_gradient_counts_as_zero():
    """A parameter with no ``.grad`` is updated as the reference updates a
    zero gradient: only its weight decay moves it."""
    params, grads = _adam_case(1)
    del params["h"]
    cfg_j = AdamWConfig_j(lr=1e-2, warmup_steps=1)
    g = {"w": jnp.asarray(grads[0]["w"]), "e": jnp.zeros((5, 3))}
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pj, _, _ = adamw_update_j(cfg_j, g, adamw_init_j(pj), pj)
    pt = {k: torch.nn.Parameter(_to_torch(v)) for k, v in params.items()}
    pt["w"].grad = _to_torch(grads[0]["w"])
    opt = adamw_init(pt)
    adamw_update(AdamWConfig(lr=1e-2, warmup_steps=1), None, opt, pt)
    for k in params:
        _assert_close_to_max(pt[k].detach().numpy(), pj[k])
    assert (pt["e"].detach().abs()
            < torch.from_numpy(np.abs(params["e"]))).all()


def test_opt_state_carries_both_ways():
    """A reference AdamW state of a reduced zamba2 (after one update) into
    the port and back, bit for bit, keyed by the port's parameter names."""
    arch = "zamba2-7b"
    ct = configs_t.reduced(configs_t.get_config(arch))
    model = Model(ct, seed=0, device="cpu")
    pj = jax.tree_util.tree_map(jnp.asarray, model_params_to_numpy(ct, model))
    grads = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 0.25), pj)
    _, opt_j, _ = adamw_update_j(AdamWConfig_j(), grads, adamw_init_j(pj), pj)
    opt_j = jax.device_get(opt_j)
    opt = opt_state_from_numpy(ct, opt_j, device="cpu")
    names = dict(model.named_parameters())
    assert int(opt.step) == 1 and opt.step.dtype == torch.int32
    assert set(opt.mu) == set(opt.nu) == set(names)
    assert all(v.dtype == torch.float32 and v.shape == names[k].shape
               for k, v in opt.mu.items())
    back = opt_state_to_numpy(ct, opt)
    for got, want in ((back.mu, opt_j.mu), (back.nu, opt_j.nu)):
        flat_g = jax.tree_util.tree_leaves_with_path(got)
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (_, g), (_, w) in zip(flat_g, flat_w):
            np.testing.assert_array_equal(g, np.asarray(w))
    assert int(back.step) == 1


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

class TestData:
    def test_stateless_resume(self):
        cfg = configs_t.reduced(configs_t.get_config("qwen2.5-3b"))
        c = SyntheticCorpus(cfg, seq_len=32, batch_size=2, seed=5)
        a = c.batch(7)
        b = SyntheticCorpus(cfg, seq_len=32, batch_size=2, seed=5).batch(7)
        assert (a["tokens"] == b["tokens"]).all()

    def test_labels_shifted(self):
        cfg = configs_t.reduced(configs_t.get_config("granite-8b"))
        c = SyntheticCorpus(cfg, seq_len=16, batch_size=1, seed=0)
        b = c.batch(0)
        assert (b["labels"][:, :-1] == b["tokens"][:, 1:]).all()
        assert b["labels"][0, -1] == -1

    def test_media_for_frontends(self):
        for arch in ("llava-next-34b", "seamless-m4t-medium"):
            cfg = configs_t.reduced(configs_t.get_config(arch))
            c = SyntheticCorpus(cfg, seq_len=32, batch_size=2, seed=0)
            assert "media" in c.batch(0)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "llava-next-34b",
                                  "seamless-m4t-medium"],
                         ids=["text", "vision", "audio"])
@pytest.mark.parametrize("reduce", [True, False], ids=["reduced", "full"])
def test_batches_equal_the_reference(arch, reduce):
    """Every frontend, reduced and at the full vocabulary and width: the
    same keys, dtypes and values as ``repro``'s corpus, at two steps."""
    cj, ct = configs_j.get_config(arch), configs_t.get_config(arch)
    if reduce:
        cj, ct = configs_j.reduced(cj), configs_t.reduced(ct)
    for step in (0, 9):
        want = Corpus_j(cj, 24, 3, seed=11).batch(step)
        got = SyntheticCorpus(ct, 24, 3, seed=11).batch(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        params = {
            "stack": {"w": np.arange(12, dtype=np.float32).reshape(3, 4)},
            "embed": np.ones((5, 2), np.float32),
        }
        save(str(tmp_path / "ck"), params, step=42)
        like = {"stack": {"w": torch.zeros(3, 4)}, "embed": torch.zeros(5, 2)}
        restored, step = restore(str(tmp_path / "ck"), like=like)
        assert step == 42
        np.testing.assert_array_equal(restored["stack"]["w"].numpy(),
                                      params["stack"]["w"])
        flat, _ = restore(str(tmp_path / "ck"))
        assert set(flat) == {"stack/w", "embed"}

    def test_model_params_roundtrip(self, tmp_path):
        cfg = configs_t.reduced(configs_t.get_config("gemma2-2b"))
        model = Model(cfg, seed=0, device="cpu")
        save(str(tmp_path / "ck"), model, step=1)
        restored, step = restore(str(tmp_path / "ck"),
                                 like=Model(cfg, seed=1, device="cpu"))
        assert step == 1
        want = model.state_dict()
        assert all(torch.equal(v, want[k])
                   for k, v in restored.state_dict().items())


def _reference_tree(arch, dtype):
    """A reduced ``arch`` in ``dtype``: the port's config and model, and
    the same weights as the reference's tree of jax arrays."""
    ct = configs_t.reduced(configs_t.get_config(arch))
    ct = type(ct)(**{**ct.__dict__, "dtype": dtype})
    model = Model(ct, seed=0, device="cpu")
    tree = model_params_to_numpy(ct, model)
    to_jax = (lambda a: jnp.asarray(a.view(jnp.bfloat16))
              if a.dtype == BF16_BITS else jnp.asarray(a))
    return ct, model, jax.tree_util.tree_map(to_jax, tree)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-7b",
                                  "moonshot-v1-16b-a3b"])
def test_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    """``repro.checkpoint.save`` of f32 weights, then the port's
    ``restore`` into a differently seeded model: every weight equal."""
    ct, model, pj = _reference_tree(arch, "float32")
    save_j(str(tmp_path / "ck"), pj, step=5, extra={"arch": arch})
    other = Model(ct, seed=9, device="cpu")
    restored, step = restore(str(tmp_path / "ck"), like=other)
    assert restored is other and step == 5
    want = model.state_dict()
    for k, v in other.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-7b",
                                  "moonshot-v1-16b-a3b"])
def test_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    """The port's ``save`` of f32 weights, then ``repro.checkpoint.restore``
    into the reference's tree: every leaf equal; the two ``meta.json``
    files equal."""
    ct, model, pj = _reference_tree(arch, "float32")
    save(str(tmp_path / "port"), model, step=3, extra={"arch": arch})
    save_j(str(tmp_path / "ref"), pj, step=3, extra={"arch": arch})
    restored, step = restore_j(str(tmp_path / "port"), like=pj)
    assert step == 3
    got = jax.tree_util.tree_leaves_with_path(restored)
    want = jax.tree_util.tree_leaves_with_path(pj)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), str(p))
    metas = [json.loads((tmp_path / d / "meta.json").read_text())
             for d in ("port", "ref")]
    assert metas[0] == metas[1]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-7b"])
def test_bf16_checkpoints_are_byte_equal_across_packages(arch, tmp_path):
    """In bf16 both packages write each bf16 leaf as its raw 2-byte bits
    (``V2``) and record ``"bfloat16"``: every ``.npz`` entry byte-equal,
    the ``meta.json`` files equal. The port restores its own and the
    reference's bit for bit (the reference's ``restore`` cannot cast a
    ``V2`` leaf back, numpy having no bfloat16)."""
    ct, model, pj = _reference_tree(arch, "bfloat16")
    save(str(tmp_path / "port"), model, step=2)
    save_j(str(tmp_path / "ref"), pj, step=2)
    with np.load(tmp_path / "port" / "params.npz") as a, \
            np.load(tmp_path / "ref" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        dtypes = set()
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k
            dtypes.add(a[k].dtype)
        # zamba2's SSM keeps D, dt_bias, A_log and D_head in f32
        assert dtypes == {BF16_BITS, *([np.dtype(np.float32)]
                                       if arch == "zamba2-7b" else [])}
    metas = [json.loads((tmp_path / d / "meta.json").read_text())
             for d in ("port", "ref")]
    assert metas[0] == metas[1]
    assert "bfloat16" in {v["dtype"] for v in metas[0]["leaves"].values()}
    want = model.state_dict()
    for d in ("port", "ref"):
        other = Model(ct, seed=9, device="cpu")
        restore(str(tmp_path / d), like=other)
        for k, v in other.state_dict().items():
            assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    flat, _ = restore(str(tmp_path / "ref"))
    assert flat["embed"].dtype == torch.bfloat16


def test_carry_roundtrip_is_bit_exact_in_bf16():
    """``model_params_to_numpy`` then ``model_params_from_numpy`` gives the
    state dict back bit for bit, bf16 leaves as their bits and the SSM's
    f32 leaves in f32."""
    ct = configs_t.reduced(configs_t.get_config("zamba2-7b"))
    ct = type(ct)(**{**ct.__dict__, "dtype": "bfloat16"})
    model = Model(ct, seed=4, device="cpu")
    tree = model_params_to_numpy(ct, model)
    assert tree["embed"].dtype == BF16_BITS
    assert tree["groups"]["ssm"]["D"].dtype == np.float32
    back = model_params_from_numpy(ct, tree, device="cpu")
    want = model.state_dict()
    assert back.keys() == want.keys()
    for k, v in back.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k


# ---------------------------------------------------------------------------
# the kernel stays on the card
# ---------------------------------------------------------------------------

def test_flash_attention_raises_on_cpu_tensors():
    q = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError, match="CUDA"):
        fa_t.flash_attention(q, q, q)
