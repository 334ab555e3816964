"""The port's training against the JAX package on the CPU.

For eight archs of the pool (every family: dense, sliding-window, VLM,
MoE, MLA, encoder-decoder, SSM, hybrid), reduced and in f32, both
packages hold the same weights: the port's seeded ``Model`` weights,
carried to the reference's tree by ``carry.model_params_to_numpy`` and
back by ``carry.model_params_from_numpy`` (the port draws them from the
same distributions as ``Model.init``, in a fraction of JAX's eager init
time). Each package takes its batches from its own ``SyntheticCorpus`` at
one seed (equal bit for bit, ``test_torch_substrate.py``). Held to the
reference:
- ``Model.loss`` and every gradient leaf against
  ``jax.value_and_grad(model.loss)`` (remat on in both), the port's
  gradients restacked into the reference's tree by
  ``carry.model_params_to_numpy``; a leaf the loss never reads (zamba2's
  Mamba-2 ``D``) has no ``.grad`` in torch and is taken as zeros, which is
  what JAX gives;
- the port's ``remat`` on and off giving the same gradients;
- three steps of the port's ``train_step`` against the reference's
  (``value_and_grad`` then ``adamw_update``): loss and grad norm at each,
  the step count after them, and zamba2's ``D`` (no gradient, so only
  weight decay moves it) as the reference's.
Then ``train`` lowers the loss over its steps, as the reference's
quickstart shows, and the kernel routes' autograd functions are held to
the plain versions with the kernel swapped for its plain version (a
monkeypatch: the CUDA kernels cannot run here; ``chip_smoke.py`` holds
them on the card).

Tolerances, stated with their reasons (measured margins in parentheses):
- loss: 1e-5 relative (measured ≤ 1.4e-7). The same f32 formulas; XLA and
  PyTorch round matmuls, transcendentals and reductions differently in
  the last bits.
- gradients: each leaf's max |port - reference| ≤ 1e-4 of the leaf's max
  |reference| (measured ≤ 4.7e-6, zamba2's tail ``dt_bias``, a sum of
  many small terms through the scan); a leaf that is zero in the
  reference is zero in the port.
- remat on vs off: equal bit for bit (the recomputation runs the same ops
  on the same inputs).
- three train steps: loss and grad norm 1e-5 relative at each step
  (measured ≤ 6.0e-7); ``D`` 1e-6 relative. The other weights are not
  compared element by element: AdamW moves an element by about
  ``g / (|g| + eps)`` times ``lr``, so where a gradient element is near
  ``eps`` a last-bit difference between the packages changes its step by
  a sizeable part of ``lr`` (measured: up to 5e-3 of a zero-initialised
  leaf's max after three steps). ``test_torch_substrate.py`` holds one
  update to the reference's on equal gradients.
- the kernel routes with the kernel swapped for its plain version:
  attention and ``ssm_scan`` equal bit for bit (the backward recomputes
  the very function the ``"ref"`` route differentiates); ``ssd_scan``
  gradients within 1e-5 relative plus 1e-5 absolute (measured 1.0e-5 on a
  gradient of 1.65: its backward differentiates the chunked form, the
  ``"ref"`` route the step-by-step recurrence, the same function summed in
  another order).
- the chunked SSD's gradient at a decay whose masked exponent overflows,
  against the step-by-step recurrence's: each within 1e-3 of the
  gradient's max (measured ≤ 7.9e-5, A's: a sum of terms that cancel, in
  two orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as configs_j
from repro.data.pipeline import SyntheticCorpus as Corpus_j
from repro.models.transformer import Model as Model_j
from repro.optim.adamw import AdamWConfig as AdamWConfig_j
from repro.optim.adamw import adamw_init as adamw_init_j
from repro.optim.adamw import adamw_update as adamw_update_j
import repro_torch.configs as configs_t
from repro_torch.carry import (
    model_params_from_numpy,
    model_params_to_numpy,
    opt_state_to_numpy as opt_to_numpy,
)
from repro_torch.checkpoint import restore
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.kernels.flash_attention import flash_attention as fa_t
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_t
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_t
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.launch.train import train, train_step
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init

ARCHS = ("qwen2.5-3b", "gemma2-2b", "llava-next-34b", "moonshot-v1-16b-a3b",
         "deepseek-v2-236b", "seamless-m4t-medium", "falcon-mamba-7b",
         "zamba2-7b")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
DECAY_RTOL = 1e-6
SSD_TOL = 1e-5
OVERFLOW_GRAD_TOL = 1e-3
B, S, SEED = 2, 32, 3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_leaves_close(got, want, tol, what):
    """Every leaf of ``got`` within ``tol`` of the max |leaf| of ``want``
    (nested dicts with the same keys); a zero leaf of ``want`` zero in
    ``got``."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= tol * scale, f"{what} {k}: {err} of max {scale}"


def _grads(model: Model) -> dict:
    """Each parameter's gradient, by name; zeros where it has none."""
    return {k: torch.zeros_like(p) if p.grad is None else p.grad
            for k, p in model.named_parameters()}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's reduced config, model, weights (the port's seeded
    ones, restacked), jitted ``value_and_grad(loss)`` and three batches."""
    cj = configs_j.reduced(configs_j.get_config(arch))
    ct = configs_t.reduced(configs_t.get_config(arch))
    mj = Model_j(cj)
    pj = jax.tree_util.tree_map(jnp.asarray, model_params_to_numpy(
        ct, Model(ct, seed=0, device="cpu")))
    corpus = Corpus_j(cj, S, B, seed=SEED)
    batches = [corpus.batch(i) for i in range(3)]
    return mj, pj, jax.jit(jax.value_and_grad(mj.loss)), batches


def _port(arch, pj):
    ct = configs_t.reduced(configs_t.get_config(arch))
    mt = Model(ct, device="cpu")
    mt.load_state_dict(model_params_from_numpy(ct, jax.device_get(pj),
                                               device="cpu"))
    mt.requires_grad_(True)
    corpus = SyntheticCorpus(ct, S, B, seed=SEED)
    return ct, mt, [corpus.batch(i) for i in range(3)]


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    _, pj, vg, batches_j = _reference(arch)
    ct, mt, batches = _port(arch, pj)
    loss_j, grads_j = vg(pj, _to_jax(batches_j[0]))
    loss = mt.loss(_to_torch(batches[0]))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    missing = {k for k, p in mt.named_parameters() if p.grad is None}
    grads_j = jax.device_get(grads_j)
    _assert_leaves_close(model_params_to_numpy(ct, _grads(mt)), grads_j,
                         GRAD_TOL, "gradient")
    if arch == "zamba2-7b":
        # Mamba-2 reads D_head, never D: no gradient in torch, zeros in JAX
        assert missing and all(k.endswith(".ssm.D") for k in missing)
        assert not np.asarray(grads_j["groups"]["ssm"]["D"]).any()
    else:
        assert not missing


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    _, pj, _, _ = _reference(arch)
    ct, mt, batches = _port(arch, pj)
    batch = _to_torch(batches[0])
    grads = {}
    for remat in (True, False):
        mt.zero_grad(set_to_none=True)
        mt.loss(batch, remat=remat).backward()
        grads[remat] = {k: v.clone() for k, v in _grads(mt).items()}
    for k, g in grads[True].items():
        assert torch.equal(g, grads[False][k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_the_reference(arch):
    """The reference's ``train_step`` (``launch/train.py``: value_and_grad
    of the loss, then ``adamw_update``) and the port's, three steps from the
    same weights on the same batches."""
    _, pj, vg, batches_j = _reference(arch)
    ct, mt, batches = _port(arch, pj)
    cfg_j = AdamWConfig_j(lr=3e-4, total_steps=3, warmup_steps=1)
    cfg_t = AdamWConfig(lr=3e-4, total_steps=3, warmup_steps=1)
    update_j = jax.jit(functools.partial(adamw_update_j, cfg_j))
    opt_j, opt_t = adamw_init_j(pj), adamw_init(mt)
    for bj, bt in zip(batches_j, batches):
        loss_j, grads_j = vg(pj, _to_jax(bj))
        pj, opt_j, info = update_j(grads_j, opt_j, pj)
        loss, gnorm = train_step(mt, cfg_t, opt_t, _to_torch(bt))
        np.testing.assert_allclose(float(loss), float(loss_j),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(gnorm), float(info["grad_norm"]),
                                   rtol=LOSS_RTOL)
        assert all(p.grad is None for p in mt.parameters())
    assert int(opt_to_numpy(ct, opt_t).step) == int(opt_j.step) == 3
    if arch == "zamba2-7b":
        got = model_params_to_numpy(ct, mt)
        for tree in ("groups", "tail"):
            d_j = np.asarray(pj[tree]["ssm"]["D"])
            assert (d_j < 1).all()          # decayed from its init of 1
            np.testing.assert_allclose(got[tree]["ssm"]["D"], d_j,
                                       rtol=DECAY_RTOL)


def test_train_lowers_the_loss(tmp_path, capsys):
    """The reference's quickstart run, on the CPU, with a checkpoint of the
    trained weights at the end."""
    hist = train("qwen2.5-3b", steps=20, batch=4, seq=64, log_every=10,
                 device="cpu", checkpoint_dir=str(tmp_path / "ck"))
    assert [r["step"] for r in hist] == [0, 10, 19]
    assert set(hist[0]) == {"step", "loss", "grad_norm", "elapsed_s"}
    assert all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[train qwen2.5-3b] {")
    cfg = configs_t.reduced(configs_t.get_config("qwen2.5-3b"))
    model, step = restore(str(tmp_path / "ck"),
                          like=Model(cfg, seed=1, device="cpu"))
    fresh = Model(cfg, seed=0, device="cpu").state_dict()
    assert step == 20
    assert any(not torch.equal(v, fresh[k])
               for k, v in model.state_dict().items())


def test_train_refuses_a_production_mesh():
    with pytest.raises(ValueError, match="mesh"):
        train("qwen2.5-3b", steps=1, mesh_kind="prod", device="cpu")


# ---------------------------------------------------------------------------
# the kernel routes' autograd functions, the kernel swapped for its plain
# version
# ---------------------------------------------------------------------------

def _attention_inputs(rng):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, 4, 24, 32), (2, 2, 24, 32), (2, 2, 24, 32))]


def _ssd_inputs(rng):
    x = rng.standard_normal((1, 32, 2, 64))
    dt = rng.uniform(0.01, 0.2, (1, 32, 2))
    A = -rng.uniform(0.5, 2.0, 2)
    Bm, Cm = (rng.standard_normal((1, 32, 64)) * 0.3 for _ in range(2))
    return [torch.from_numpy(a.astype(np.float32))
            for a in (x, dt, A, Bm, Cm)]


def _ssm_inputs(rng):
    u = rng.standard_normal((2, 24, 16))
    dt = rng.uniform(0.01, 0.2, (2, 24, 16))
    A = -rng.uniform(0.5, 2.0, (16, 16))
    Bm, Cm = (rng.standard_normal((2, 24, 16)) for _ in range(2))
    return [torch.from_numpy(a.astype(np.float32))
            for a in (u, dt, A, Bm, Cm)]


_ROUTES = {
    # kernel: (ops module, the kernel's name there, its plain version,
    #          op, inputs, op kwargs, gradients' rtol and atol)
    "flash_attention": (fa_ops, "flash_attention", attention_ref,
                        fa_ops.attention_op, _attention_inputs,
                        dict(causal=True, window=8, softcap=20.0), 0.0),
    "ssd_scan": (ssd_ops, "ssd_scan", ssd_scan_ref, ssd_ops.ssd_scan_op,
                 _ssd_inputs, dict(chunk=8), SSD_TOL),
    "ssm_scan": (ssm_ops, "ssm_scan", ssm_scan_ref, ssm_ops.ssm_scan_op,
                 _ssm_inputs, {}, 0.0),
}


@pytest.mark.parametrize("kernel", list(_ROUTES))
def test_kernel_route_differentiates_like_the_plain_version(kernel,
                                                            monkeypatch):
    """The ``"kernel"`` route with its kernel replaced by the plain version
    (on the card the CUDA kernel computes it): the same output, and
    gradients for every input, equal to the ``"ref"`` route's autograd."""
    mod, name, plain, op, inputs, kw, tol = _ROUTES[kernel]
    calls = []

    def fake_kernel(*xs, **kwargs):
        assert not torch.is_grad_enabled()
        calls.append(1)
        return plain(*xs, **kwargs)

    monkeypatch.setattr(mod, name, fake_kernel)
    xs = inputs(np.random.default_rng(5))
    out, grads = {}, {}
    for backend in ("kernel", "ref"):
        leaves = [x.clone().requires_grad_(True) for x in xs]
        y = op(*leaves, backend=backend, **kw)
        w = torch.from_numpy(np.random.default_rng(6).standard_normal(
            tuple(y.shape)).astype(np.float32))
        (y * w).sum().backward()
        out[backend] = y.detach()
        grads[backend] = [x.grad for x in leaves]
    assert len(calls) == 1
    torch.testing.assert_close(out["kernel"], out["ref"], rtol=0, atol=0)
    for gk, gr in zip(grads["kernel"], grads["ref"]):
        assert gk is not None and gk.dtype == gr.dtype
        torch.testing.assert_close(gk, gr, rtol=tol, atol=tol)


def test_kernel_route_skips_inputs_that_need_no_gradient(monkeypatch):
    """Only the inputs that require grad are differentiated."""
    monkeypatch.setattr(fa_ops, "flash_attention",
                        lambda *xs, **kw: attention_ref(*xs, **kw))
    q, k, v = _attention_inputs(np.random.default_rng(7))
    q.requires_grad_(True)
    fa_ops.attention_op(q, k, v, backend="kernel").sum().backward()
    assert q.grad is not None and k.grad is None and v.grad is None


@pytest.mark.parametrize("kernel", list(_ROUTES))
def test_direct_kernel_call_with_grad_raises(kernel):
    """A direct call of the kernel with an input that requires grad, under
    grad mode, would drop the gradient: it raises and names the ``ops.py``
    route; under ``no_grad`` it reaches the device check as before."""
    wrapper = {"flash_attention": fa_t.flash_attention,
               "ssd_scan": ssd_t.ssd_scan, "ssm_scan": ssm_t.ssm_scan}[kernel]
    route = {"flash_attention": "attention_op", "ssd_scan": "ssd_scan_op",
             "ssm_scan": "ssm_scan_op"}[kernel]
    xs = _ROUTES[kernel][4](np.random.default_rng(8))
    xs[0].requires_grad_(True)
    with pytest.raises(ValueError, match=f"ops.{route}"):
        wrapper(*xs)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        wrapper(*xs)


def test_chunked_ssd_gradient_stays_finite_where_the_reference_overflows():
    """With a fast decay (dt·|A| summed over a chunk past 88) the masked
    upper triangle's exp(L_t - L_s) overflows to inf in f32. The
    reference's ``_ssd_chunked`` masks after the exp, so its vjp is
    inf · 0 = NaN for dt and A; the port masks the exponent first: the
    same forward, and each gradient within OVERFLOW_GRAD_TOL of the max
    |gradient| of the step-by-step recurrence."""
    from repro.models.ssm import _ssd_chunked as ssd_chunked_j
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

    rng = np.random.default_rng(9)
    xs = [rng.standard_normal((1, 64, 2, 8)), np.full((1, 64, 2), 0.5),
          np.array([-16.0, -4.0]), rng.standard_normal((1, 64, 4)),
          rng.standard_normal((1, 64, 4))]
    xs = [a.astype(np.float32) for a in xs]
    grads_j = jax.grad(lambda *a: ssd_chunked_j(*a, 64).sum(),
                       argnums=range(5))(*map(jnp.asarray, xs))
    assert not all(np.isfinite(np.asarray(g)).all() for g in grads_j)
    got, want = [], []
    for fn, out in ((lambda *a: ssd_chunked_ref(*a, 64), got),
                    (ssd_scan_ref, want)):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in xs]
        fn(*leaves).sum().backward()
        out.extend(x.grad for x in leaves)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max() <= OVERFLOW_GRAD_TOL * w.abs().max()
