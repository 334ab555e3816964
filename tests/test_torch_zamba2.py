"""The published Zamba2 layout's pieces in the port: the SSD scan with B
and C in state groups (the plain versions here; the CUDA kernel on the
card), flash attention at head dim 224 with a given scale (on the card),
the attention scale and exact GELU of the plain paths, and the published
model's shape on ``meta``. Tests that need the card skip without one."""

import dataclasses

import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.zamba2_7b_instruct import CONFIG
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_scan_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import act_fn
from repro_torch.models.transformer import Model
from repro_torch.models.zamba2_layout import is_published, mamba_ngroups


def _ssd_inputs(B=2, S=64, H=6, P=16, G=2, N=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g) - 2)
    A = -torch.rand(H, generator=g) * 2 - 0.1
    Bm = torch.randn(B, S, G, N, generator=g)
    Cm = torch.randn(B, S, G, N, generator=g)
    return x, dt, A, Bm, Cm


def test_grouped_chunked_ssd_is_two_single_group_calls_on_the_halves():
    """G = 2: the first half of the heads reads group 0, the second half
    group 1, as two G = 1 calls on the halves give."""
    x, dt, A, Bm, Cm = _ssd_inputs()
    y = ssd_chunked_ref(x, dt, A, Bm, Cm, 16)
    h = x.shape[2] // 2
    halves = torch.cat([ssd_chunked_ref(x[:, :, s], dt[:, :, s], A[s],
                                        Bm[:, :, g], Cm[:, :, g], 16)
                        for g, s in ((0, slice(0, h)), (1, slice(h, None)))],
                       dim=2)
    assert torch.allclose(y, halves, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("G", [1, 2, 3])
def test_grouped_chunked_ssd_is_the_step_recurrence(G):
    x, dt, A, Bm, Cm = _ssd_inputs(G=G)
    y = ssd_chunked_ref(x, dt, A, Bm, Cm, 16)
    want = ssd_scan_ref(x, dt, A, Bm, Cm)
    assert torch.allclose(y, want, rtol=1e-4, atol=1e-4 * want.abs().max())


def test_one_group_in_four_dims_is_the_three_dim_layout():
    x, dt, A, Bm, Cm = _ssd_inputs(G=1)
    for fn in (lambda *a: ssd_chunked_ref(*a, 16), ssd_scan_ref):
        four = fn(x, dt, A, Bm, Cm)
        three = fn(x, dt, A, Bm[:, :, 0], Cm[:, :, 0])
        assert torch.allclose(four, three, rtol=1e-5, atol=1e-5)


def test_attention_ref_takes_a_scale():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 4, 9, 32, generator=g) for _ in range(3))
    s = 16 ** -0.5
    # scaling q by s / hd^-0.5 is the same as scaling the scores by s
    assert torch.allclose(attention_ref(q, k, v, scale=s),
                          attention_ref(q * s / 32 ** -0.5, k, v),
                          atol=1e-6)
    assert torch.equal(attention_ref(q, k, v, scale=None),
                       attention_ref(q, k, v))


def test_exact_gelu_is_not_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    assert torch.equal(act_fn("gelu_exact")(x),
                       torch.nn.functional.gelu(x))
    assert not torch.equal(act_fn("gelu_exact")(x), act_fn("gelu")(x))


def test_the_published_layout_is_kept_out_of_the_parity_archs():
    """The JAX package has no such model: the configuration is its own
    module, outside ``ARCHS``, and the pinned zamba2-7b keeps the
    reference's layout."""
    assert CONFIG.name not in ARCHS
    assert is_published(CONFIG) and mamba_ngroups(CONFIG) == 2
    pinned = get_config("zamba2-7b")
    assert not is_published(pinned) and mamba_ngroups(pinned) == 0
    assert type(pinned) is ModelConfig


def test_the_published_model_on_meta():
    cfg = CONFIG
    model = Model(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() == 7_356_749_648
    assert len(model.mamba_layers) == 81 and len(model.shared) == 2
    assert len(model.adapters) == len(model.hybrid_linear) == 13
    assert model.mamba_layers[0].ssm["in_proj"].shape == (3584, 14704)
    assert model.mamba_layers[0].ssm["conv_w"].shape == (4, 7424)
    assert model.shared[0].attn["wq"].shape == (7168, 32, 224)
    assert model.shared[0].attn["wo"].shape == (32, 224, 3584)


def test_the_published_layout_does_not_decode():
    cfg = dataclasses.replace(
        CONFIG, n_layers=3, d_model=32,
        n_heads=2, n_kv_heads=2, head_dim=32, d_ff=64, vocab_size=64,
        ssm_head_dim=16, ssm_state=8, ssm_chunk=8, hybrid_layer_ids=(1,),
        attention_hidden_size=64, adapter_rank=4, dtype="float32")
    model = Model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="decode"):
        model.init_decode_state(1, 8)
    with pytest.raises(NotImplementedError, match="decode"):
        model.decode_step({"pos": torch.zeros(1, dtype=torch.int32)},
                          torch.zeros(1, dtype=torch.long))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B, S, H, G", [(1, 512, 112, 2), (2, 77, 4, 2),
                                        (1, 256, 6, 3), (1, 128, 4, 1)])
def test_grouped_ssd_kernel_is_its_plain_version(cuda, dtype, B, S, H, G):
    """Within 1e-4 of max |y| in f32, one bf16 ulp of it in bf16, as
    ``chip_smoke.py`` holds the scans."""
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

    x, dt, A, Bm, Cm = (t.to(cuda) for t in _ssd_inputs(
        B=B, S=S, H=H, P=64, G=G, N=64, seed=S + H))
    x, Bm, Cm = (t.to(dtype) for t in (x, Bm, Cm))
    got = ssd_scan(x, dt, A, Bm, Cm).float()
    want = ssd_scan_ref(x, dt, A, Bm, Cm).float()
    top = want.abs().max()
    tol = 1e-4 * top if dtype == torch.float32 else top * 2 ** -7
    assert (got - want).abs().max() <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B, H, K, S", [(1, 32, 32, 1024), (2, 4, 2, 77)])
def test_head_dim_224_with_a_scale_is_attention_ref(cuda, dtype, B, H, K,
                                                    S):
    """Within 2e-5 (f32) / 1.6e-2 (bf16) of the plain version, as
    ``chip_smoke.py`` holds attention."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )

    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn(B, H, S, 224, generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn(B, K, S, 224, generator=g, device=cuda, dtype=dtype)
            for _ in range(2))
    scale = 112 ** -0.5
    got = flash_attention(q, k, v, causal=True, scale=scale).float()
    want = attention_ref(q, k, v, causal=True, scale=scale).float()
    tol = 2e-5 if dtype == torch.float32 else 1.6e-2
    assert (got - want).abs().max() <= tol
    # the scale reaches the kernel: the default scale gives another answer
    other = flash_attention(q, k, v, causal=True).float()
    assert (other - want).abs().max() > tol


def _chip_smoke():
    """``chip_smoke.py`` from the repository's root, as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_smokes_hd_224_and_grouped_ssd_cases_are_declared():
    """Each case ``chip_smoke.py`` runs at head dim 224 or with B and C in
    state groups is a registered launch geometry, so the launch checker
    sees the shapes the card runs; the scaled cases are those at hd 224."""
    from repro_torch.analysis.launch_check import load_registry
    from repro_torch.kernels.flash_attention import flash_attention as fa

    smoke = _chip_smoke()
    registry = load_registry()
    attn = {(g.case.split("-")[0], g.inputs[0].array_shape,
             g.inputs[1].array_shape)
            for g in registry["flash_attention"]()}
    hd224 = [c for c in smoke.ATTN_CASES if c[5] == 224]
    assert {c[0] for c in hd224} == set(smoke.ATTN_SCALE)
    assert {c[6] for c in hd224} == {torch.bfloat16, torch.float32}
    for name, B, H, K, S, hd, dt, *_ in hd224:
        assert (fa.route(dt), (B, H, S, hd), (B, K, S, hd)) in attn, name
    ssd = {(g.inputs[0].array_shape, g.inputs[3].array_shape)
           for g in registry["ssd_scan"]()}
    grouped = [c for c in smoke.SSD_CASES if c[4]]
    assert {c[4] for c in grouped} == {2, 3}
    for name, B, S, H, G, P, N, _ in smoke.SSD_CASES:
        rows = (B, S, G, N) if G else (B, S, N)
        assert ((B, S, H, P), rows) in ssd, name
