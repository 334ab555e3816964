"""The Zamba2 prefill cell on the CPU at a tiny size: a cell of new files
runs through the harness on the port's plain path with the spans driver;
the plain reference is the port's forward, and transformers' own Zamba2
within a chunk; the control and five faults planted under the timed path
come out not correct; the FLOP count is ``FlopCounterMode``'s; the
readers read what a traced slice gives them and nothing of another
cell's; the configuration is the published one.

The tiny model keeps every mechanism of the published one: 10 layers
with hybrid calls before layers 2, 5 and 8, so that both shared blocks
alternate, three adapters are used, and Mamba-only layers lie between
and after the calls; two state groups; head dim 32 over a 128-wide
concatenation."""

import dataclasses
import importlib.util
import itertools
import json
import time
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from chipbench import harness, peaks
from chipbench.counts import zamba2 as count
from chipbench.drivers import model_prefill, model_prefill_spans as driver
from chipbench.reference import zamba2 as ref

PKG = Path(__file__).resolve().parent
METRICS = PKG / "metrics"
CELL = "zamba2-7b-instruct.prefill-mixed-4k"
TINY = "zamba2-tiny.prefill-tiny-4k"
SEED = 2**31 + 33
NEW_READERS = ("ssd_scan_roofline", "mamba2_device_ms",
               "shared_block_device_ms")


def _config() -> dict:
    return json.loads((PKG / "configs" / "zamba2-7b-instruct.json")
                      .read_text())


def tiny_config() -> dict:
    return dict(_config(), name="zamba2-tiny", hidden_size=64,
                num_hidden_layers=10, hybrid_layer_ids=[2, 5, 8],
                n_mamba_heads=8, mamba_headdim=16, mamba_d_state=8,
                chunk_size=16, attention_hidden_size=128,
                num_attention_heads=4, num_key_value_heads=4,
                attention_head_dim=32, intermediate_size=128, adapter_rank=8,
                vocab_size=256)


def tiny_traffic() -> dict:
    traffic = json.loads((PKG / "traffic" / "prefill-mixed-4k.json")
                         .read_text())
    traffic.update(prompts=16, block=8, median_tokens=48, min_tokens=16,
                   max_tokens=96, multiple=16, step_tokens=192,
                   sample_steps=4, sample_random=2, trace_steps=[2, 4])
    return traffic


def add_tiny_zamba2_cell(root: Path) -> str:
    """A tiny Zamba2, a tiny 4k mix and their cell, as new files and
    ``BENCHMARK.json`` entries only; the cell joins every metric that
    lists the Zamba2 cell."""
    pkg = root / "chipbench"
    (pkg / "configs" / "zamba2-tiny.json").write_text(
        json.dumps(tiny_config()))
    (pkg / "traffic" / "prefill-tiny-4k.json").write_text(
        json.dumps(tiny_traffic()))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = next(c for c in bench["configs"]
               if c["name"] == "zamba2-7b-instruct")
    bench["configs"].append(dict(cfg, name="zamba2-tiny",
                                 file="chipbench/configs/zamba2-tiny.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    bench["workloads"].append(dict(cell, name=TINY, config="zamba2-tiny",
                                   traffic="prefill-tiny-4k"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return TINY


@pytest.fixture
def tiny_zamba2(bench_copy):
    return bench_copy, add_tiny_zamba2_cell(bench_copy)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tiny runs share the machine with other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(root, cell, program=None, seed=SEED, trace=False):
    return harness.run_cell(root, cell, seed=seed, seconds=3.0,
                            trace=trace, device="cpu",
                            t_start=time.perf_counter(), program=program)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name.replace('.', '_')}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model(config, weights):
    from repro_torch.models.transformer import Model

    model = Model(model_prefill.port_config(config), device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    return model


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------

def test_a_tiny_zamba2_cell_runs_on_the_plain_path(tiny_zamba2):
    line = _run(*tiny_zamba2)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["checks"]["sampled_not_sent"]["value"] == 0
    spec = harness.cell_spec(*tiny_zamba2)
    assert {m["name"] for m in spec["per_layer"]} == {
        "prefill_mfu", "flash_attention_roofline",
        "device_idle_share.prefill", *NEW_READERS}


def test_the_cell_is_in_the_benchmark():
    spec = harness.cell_spec(harness.ROOT, CELL)
    assert spec["cell"]["chips"] == 1
    assert spec["traffic"]["driver"] == "model_prefill_spans"
    assert {m["name"] for m in spec["end_to_end"]} == {
        "prefill_tokens_per_s", "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == {
        "prefill_mfu", "flash_attention_roofline",
        "device_idle_share.prefill", *NEW_READERS}


def test_the_traffic_clips_at_the_models_context():
    traffic = json.loads((PKG / "traffic" / "prefill-mixed-4k.json")
                         .read_text())
    lengths = model_prefill.prompt_lengths(traffic, SEED)
    assert lengths.min() == 256 and lengths.max() == 4096
    assert (lengths % 256 == 0).all()
    assert 0.08 < (lengths == 4096).mean() < 0.12
    schedule = model_prefill.Schedule(lengths, traffic["step_tokens"])
    assert sorted(schedule.shapes()) == sorted(
        (16384 // S, S) for S in set(lengths.tolist()))
    assert {B for B, _ in schedule.shapes()} >= {64, 4}
    # every sampled prompt lies in the first steps of the window
    picked = model_prefill.sample(lengths, traffic, SEED)
    steps = list(itertools.islice(schedule, 16))
    at = [n for n, (_, ids) in enumerate(steps) if set(ids) & picked]
    assert len(picked) >= 8 and max(at) < 12


def test_the_same_seed_gives_the_same_weights():
    config, traffic = tiny_config(), tiny_traffic()
    a = driver.inputs(config, traffic, ref, SEED, "cpu")[0]
    b = driver.inputs(config, traffic, ref, SEED, "cpu")[0]
    c = driver.inputs(config, traffic, ref, SEED + 1, "cpu")[0]
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    dt = "mamba_layers.3.ssm.dt_bias"
    assert not torch.equal(a[dt], c[dt])
    # the published init: dt = softplus(dt_bias) on [1e-3, 0.1]
    for i in range(config["num_hidden_layers"]):
        p = f"mamba_layers.{i}.ssm."
        d = torch.nn.functional.softplus(a[p + "dt_bias"])
        assert a[p + "dt_bias"].dtype == torch.float32
        assert 1e-3 * 0.999 <= d.min() and d.max() <= 0.1 * 1.001
        assert torch.equal(a[p + "A_log"], torch.log(torch.arange(1.0, 9.0)))
        assert torch.equal(a[p + "D_head"], torch.ones(8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_reference_is_the_ports_forward(dtype):
    """The port's forward on the CPU against the reference on the same
    weights: in float32 to rounding, in bfloat16 within the limits."""
    config, traffic = dict(tiny_config(), torch_dtype=dtype), tiny_traffic()
    weights, lengths, tokens, batch, _ = driver.inputs(config, traffic, ref,
                                                       SEED, "cpu")
    model = _model(config, weights)
    schedule = model_prefill.Schedule(lengths, traffic["step_tokens"])
    for S, ids in itertools.islice(schedule, 3):
        with torch.no_grad():
            got = model({"tokens": batch(S, ids)})[0][:, S - 1].float()
        want = torch.cat([ref.forward_rows(
            config, weights, tokens(k), torch.tensor([S - 1]))
            for k in ids])
        err = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
        if dtype == "float32":
            assert err < 1e-5
        else:
            assert 1e-5 < err < config["check"]["row_err_max"]


def test_the_reference_is_transformers_zamba2_within_a_chunk():
    """transformers' ``Zamba2ForCausalLM`` (its plain torch path) on the
    reference's weights gives the reference's logits at every position of
    prompts up to 64 tokens, in one chunk of its own. Its torch path
    across chunks is left out: it disagrees with its own single chunk at
    these sizes, where the chunked form and the step-by-step recurrence
    agree (``tests/test_torch_zamba2.py``). The reference runs in chunks
    of 16 here, so its chunked form is held to transformers' single
    chunk. transformers' lower clamp of dt (its torch path's, which its
    CUDA path does not apply) is set below any dt."""
    transformers = pytest.importorskip("transformers")
    config = dict(tiny_config(), torch_dtype="float32")
    traffic = dict(tiny_traffic(), max_tokens=64)
    w, lengths, tokens, _, _ = driver.inputs(config, traffic, ref, SEED,
                                             "cpu")
    # the reference in chunks of 16, transformers in one chunk of 64
    model = _hf_model(transformers, dict(config, chunk_size=64), w)
    for k in range(4):
        t = tokens(k)
        with torch.no_grad():
            got = model(input_ids=t[None], use_cache=False).logits[0]
        want = ref.forward_rows(config, w, t, torch.arange(t.shape[0]))
        err = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max()
        assert err < 1e-5


def _hf_model(transformers, c, w):
    L, call = c["num_hidden_layers"], {
        layer: k for k, layer in enumerate(c["hybrid_layer_ids"])}
    hc = transformers.Zamba2Config(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_hidden_layers=L, layers_block_type=[
            "hybrid" if i in call else "mamba" for i in range(L)],
        mamba_d_state=c["mamba_d_state"], mamba_d_conv=c["mamba_d_conv"],
        mamba_expand=c["mamba_expand"], mamba_ngroups=c["mamba_ngroups"],
        n_mamba_heads=c["n_mamba_heads"], chunk_size=c["chunk_size"],
        intermediate_size=c["intermediate_size"], hidden_act="gelu",
        num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c["num_key_value_heads"],
        num_mem_blocks=c["num_mem_blocks"], adapter_rank=c["adapter_rank"],
        use_shared_attention_adapter=False, use_mem_rope=True,
        rope_theta=c["rope_theta"], rms_norm_eps=c["rms_norm_eps"],
        time_step_min=1e-30, tie_word_embeddings=True)
    hc._attn_implementation = "eager"
    model = transformers.Zamba2ForCausalLM(hc).float().eval()
    f = lambda k: w[k].float()          # noqa: E731
    one = lambda k: 1.0 + f(k)          # noqa: E731
    A, D = c["attention_hidden_size"], c["hidden_size"]
    sd = {"model.embed_tokens.weight": f("embed"),
          "lm_head.weight": f("embed"),
          "model.final_layernorm.weight": one("ln_f")}
    for i in range(L):
        m = f"model.layers.{i}." + ("mamba_decoder." if i in call else "")
        p = f"mamba_layers.{i}."
        sd.update({
            m + "input_layernorm.weight": one(p + "ln"),
            m + "mamba.in_proj.weight": f(p + "ssm.in_proj").T,
            m + "mamba.conv1d.weight": f(p + "ssm.conv_w").T[:, None, :],
            m + "mamba.conv1d.bias": f(p + "ssm.conv_b"),
            m + "mamba.dt_bias": f(p + "ssm.dt_bias"),
            m + "mamba.A_log": f(p + "ssm.A_log"),
            m + "mamba.D": f(p + "ssm.D_head"),
            m + "mamba.norm.weight": one(p + "ssm.norm_scale"),
            m + "mamba.out_proj.weight": f(p + "ssm.out_proj").T})
        if i not in call:
            continue
        k = call[i]
        s, q = f"model.layers.{i}.shared_transformer.", \
            f"shared.{k % c['num_mem_blocks']}."
        adapter = s + f"feed_forward.gate_up_proj_adapter_list.{k}."
        sd.update({
            f"model.layers.{i}.linear.weight": f(f"hybrid_linear.{k}").T,
            s + "input_layernorm.weight": one(q + "ln1"),
            s + "pre_ff_layernorm.weight": one(q + "ln2"),
            s + "self_attn.q_proj.weight": f(q + "attn.wq").reshape(A, -1).T,
            s + "self_attn.k_proj.weight": f(q + "attn.wk").reshape(A, -1).T,
            s + "self_attn.v_proj.weight": f(q + "attn.wv").reshape(A, -1).T,
            s + "self_attn.o_proj.weight":
                f(q + "attn.wo").reshape(-1, D).T,
            s + "feed_forward.gate_up_proj.weight": torch.cat(
                [f(q + "mlp.wg"), f(q + "mlp.wu")], 1).T,
            s + "feed_forward.down_proj.weight": f(q + "mlp.wd").T,
            adapter + "0.weight": f(f"adapters.{k}.wa").T,
            adapter + "1.weight": torch.cat(
                [f(f"adapters.{k}.wg"), f(f"adapters.{k}.wu")], 1).T})
    # a shared block's modules appear under every layer that calls it:
    # each is set through one of its names
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all("adapter_list" in name for name in missing)
    return model


# ---------------------------------------------------------------------------
# the control and planted faults
# ---------------------------------------------------------------------------

def test_the_control_is_not_correct(tiny_zamba2):
    line = _run(*tiny_zamba2, program="control")
    assert line["correct"] is False
    assert line["checks"]["row_err_max"]["value"] > \
        line["checks"]["row_err_max"]["limit"]


def _adapter_left_out(monkeypatch):
    from repro_torch.models import layers, transformer

    monkeypatch.setattr(transformer, "adapted_mlp",
                        lambda p, adapter, x, act: layers.mlp(p, x, act))


def _one_shared_block_for_every_call(monkeypatch):
    from repro_torch.models import transformer

    real = transformer.SharedBlock.forward
    first = []

    def first_block(self, *a, **k):
        first.append(self)
        return real(first[0], *a, **k)

    monkeypatch.setattr(transformer.SharedBlock, "forward", first_block)


def _embedding_concatenation_left_out(monkeypatch):
    from repro_torch.models import transformer

    real = transformer.SharedBlock.forward

    def no_embedding(self, x, emb, *a, **k):
        return real(self, x, torch.zeros_like(emb), *a, **k)

    monkeypatch.setattr(transformer.SharedBlock, "forward", no_embedding)


def _one_state_group(monkeypatch):
    """``mamba_ngroups`` 1: every head reads the first group's B and C,
    and the gated norm spans every channel."""
    from repro_torch.models import ssm

    real_scan, real_norm = ssm._ssd_chunked, ssm.gated_rms_norm

    def first_group(x, dt, A, B, C, chunk):
        return real_scan(x, dt, A, B[:, :, :1].expand_as(B),
                         C[:, :, :1].expand_as(C), chunk)

    monkeypatch.setattr(ssm, "_ssd_chunked", first_group)
    monkeypatch.setattr(ssm, "gated_rms_norm",
                        lambda y, z, s, groups, eps: real_norm(y, z, s, 1,
                                                               eps))


def _scale_over_the_whole_head(monkeypatch):
    """Attention scaled by hd^-0.5 where Zamba2 takes (hd / 2)^-0.5."""
    from repro_torch.models import transformer

    real = transformer._attn_dims
    monkeypatch.setattr(transformer, "_attn_dims", lambda cfg: dataclasses
                        .replace(real(cfg), scale=None))


@pytest.mark.parametrize("plant", [
    _adapter_left_out, _one_shared_block_for_every_call,
    _embedding_concatenation_left_out, _one_state_group,
    _scale_over_the_whole_head], ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_is_not_correct(tiny_zamba2, monkeypatch, plant):
    plant(monkeypatch)
    line = _run(*tiny_zamba2)
    assert line["correct"] is False
    assert line["failed"] > 0


def test_device_metrics_without_a_card_fail(tiny_zamba2):
    if torch.cuda.is_available():
        pytest.skip("this test checks a machine without a card")
    with pytest.raises((RuntimeError, AssertionError)):
        _run(*tiny_zamba2, trace=True)


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, S", [(1, 16), (3, 32), (2, 48)])
def test_the_flop_count_is_flop_counter_modes(B, S):
    """The port's forward on the CPU computes attention as a masked dense
    product, so ``FlopCounterMode`` counts all S^2 pairs there, and the
    logits at every position; the SSD runs in its chunked form."""
    from repro_torch.models.transformer import Model

    config = dict(tiny_config(), torch_dtype="float32")
    model = Model(model_prefill.port_config(config), seed=3, device="cpu")
    tokens = torch.arange(B * S).view(B, S) % config["vocab_size"]
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model({"tokens": tokens})
    dense = B * (count.layer_flops(config, S) + count.logit_flops(config, S)
                 + count.attention_flops(config, S, causal=False)
                 + count.ssd_flops(config, S))
    assert fc.get_total_flops() == dense
    assert count.forward_flops(config, S, B) == dense - B * (
        count.logit_flops(config, S - 1)
        + count.attention_flops(config, S, causal=False)
        - count.attention_flops(config, S))


def test_the_counts_at_the_published_widths():
    config = _config()
    # ~12.7 GFLOP a token in the 81 mixers' projections, ~9.1 in the 13
    # hybrid calls
    mixers = 2 * 81 * (3584 * 14704 + 7168 * 3584)
    calls = 2 * 13 * (7168 * 3 * 7168 + 7168 * 3584 + 3 * 3584 * 14336
                      + 128 * (3584 + 2 * 14336) + 3584 * 3584)
    assert count.layer_flops(config, 1) == mixers + calls
    assert 12.6e9 < mixers < 12.8e9 and 9.0e9 < calls < 9.2e9
    assert count.logit_flops(config, 1) == 2 * 3584 * 32000
    # the SSD's chunked form: 2 Q^2 (G N + H P) + 4 Q N H P a chunk
    assert count.ssd_flops(config, 256) == 81 * (
        2 * 256 ** 2 * (2 * 64 + 112 * 64) + 4 * 256 * 64 * 112 * 64)
    for S, B in ((256, 64), (4096, 4)):
        attn = count.attention_launches(config, S, B)
        assert len(attn) == 13
        assert attn[0] == (B * 4 * 32 * 224 * count.causal_pairs(S),
                           B * 2 * S * 224 * (32 + 32 + 32 + 32))
        ssd = count.ssd_launches(config, S, B)
        assert len(ssd) == 81
        # x and y, dt, B and C in their two groups, A
        assert ssd[0][1] == B * S * (4 * 112 * 64 + 4 * 112 + 4 * 2 * 64) \
            + 4 * 112
        # the bytes bind the scan
        assert ssd[0][1] / peaks.HBM_BYTES_PER_S > \
            ssd[0][0] / peaks.BF16_FLOP_PER_S


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def _ctx(config, steps, n_attn=13, n_ssd=81, spans=True):
    """A traced prefill context of ``steps`` [(B, S)], its kernels and
    its spans, 1 device ms each."""
    trace = {"wall_s": 1.0, "busy_s": 0.9, "device_ops": 9, "by_name": {
        "void flash_attention_wgmma_kernel<224>(CUtensorMap)": {
            "count": n_attn * len(steps), "seconds": 1e-3 * len(steps)},
        "void ssd_scan_mma_kernel<64, 64>(...)": {
            "count": n_ssd * len(steps), "seconds": 2e-2 * len(steps)}}}
    recs = []
    if spans:
        for _ in steps:
            recs += [{"name": "model/mamba2", "device_ms": 1.0}] * 81
            recs += [{"name": "model/shared_block", "device_ms": 1.0}] * 13
    return {"trace": trace, "spans": recs,
            "prefill": {"config": config, "count": "zamba2",
                        "traced_steps": [list(s) for s in steps],
                        "untraced_steps": [[4, 4096]], "untraced_s": 1.0}}


def test_the_new_readers():
    config = _config()
    steps = [(4, 4096), (64, 256)]
    ctx = _ctx(config, steps)
    bound = 81 * sum(peaks.bound_s(ops, peaks.BF16_FLOP_PER_S, b) for ops, b
                     in (count.ssd_launches(config, 4096, 4)[0],
                         count.ssd_launches(config, 256, 64)[0]))
    assert _reader("ssd_scan_roofline").read(ctx) == pytest.approx(
        100 * bound / 4e-2)
    # 81 and 13 spans of 1 ms a step, over two steps of 16,384 tokens
    assert _reader("mamba2_device_ms").read(ctx) == pytest.approx(81.0)
    assert _reader("shared_block_device_ms").read(ctx) == pytest.approx(13.0)
    # launches that are not one a Mamba-2 layer of each step: no reading
    assert _reader("ssd_scan_roofline").read(
        _ctx(config, steps, n_ssd=80)) is None
    # a program without the spans, or a span without device time
    for name in NEW_READERS[1:]:
        assert _reader(name).read(_ctx(config, steps, spans=False)) is None
        bad = _ctx(config, steps)
        bad["spans"][0] = dict(bad["spans"][0], device_ms=None)
        bad["spans"][-1] = dict(bad["spans"][-1], device_ms=None)
        assert _reader(name).read(bad) is None
    # the flash-attention reader reads the Zamba2 cell's 13 launches a step
    assert _reader("flash_attention_roofline").read(ctx) is not None


@pytest.mark.parametrize("name", NEW_READERS)
def test_a_new_reader_reads_nothing_of_another_cell(name):
    qwen = json.loads((PKG / "configs" / "qwen2.5-3b.json").read_text())
    fleet_ctx = {"trace": {"wall_s": 1.0, "busy_s": 0.5, "device_ops": 0,
                           "launches": 0, "by_name": {}},
                 "ticks": 40, "fleet": {}, "spans": [
                     {"name": "fleet/tick", "device_ms": 1.0}]}
    qwen_ctx = {"trace": {"wall_s": 1.0, "busy_s": 0.9, "device_ops": 9,
                          "by_name": {"flash_attention_wgmma_kernel<128>": {
                              "count": 36, "seconds": 1e-3}}},
                "prefill": {"config": qwen, "count": "dense_decoder",
                            "traced_steps": [[64, 256]],
                            "untraced_steps": [[64, 256]],
                            "untraced_s": 1.0}}
    for ctx in (fleet_ctx, qwen_ctx, None):
        assert _reader(name).read(ctx) is None


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_the_port_config_is_the_published_one():
    """The file sets the port's module's fields to what they already
    are, and holds the published widths."""
    from repro_torch.configs import zamba2_7b_instruct
    from repro_torch.models import transformer

    config = _config()
    cfg = model_prefill.port_config(config)
    assert cfg == zamba2_7b_instruct.CONFIG
    assert config["reduced"] == []
    assert [i for i, t in enumerate(config["layers_block_type"])
            if t == "hybrid"] == config["hybrid_layer_ids"] == list(
        cfg.hybrid_layer_ids)
    assert (cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.d_ff) == (
        81, 3584, 224, 14336)
    assert (cfg.attention_hidden_size, cfg.num_mem_blocks, cfg.adapter_rank,
            cfg.mamba_ngroups) == (7168, 2, 128, 2)
    assert config["attention_head_dim"] * config["num_attention_heads"] == \
        config["attention_hidden_size"]
    assert transformer._attn_dims(cfg).scale == pytest.approx(
        (224 / 2) ** -0.5)
    assert cfg.act == "gelu_exact" and config["hidden_act"] == "gelu"
    assert set(config["assumed"]) >= {
        "attention_scale", "rope", "hidden_act", "tie_word_embeddings",
        "gated_norm", "dt", "weights", "torch_dtype"}
    assert set(config["check"]["why"]) == {"row_err_max", "logit_gap_max"}


def test_the_weights_are_the_ports_state_dict():
    """``weight_specs`` and ``other_weights`` name every parameter of the
    port's model, in its shape, at the published widths."""
    from repro_torch.models.transformer import Model

    config = _config()
    model = Model(model_prefill.port_config(config), device="meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {name: shape for name, shape, _ in ref.weight_specs(config)}
    got.update((name, tuple(t.shape)) for name, t in ref.other_weights(
        config, "cpu", torch.Generator().manual_seed(0)).items())
    assert got == want
    assert sum(map(lambda s: torch.Size(s).numel(), want.values())) == \
        7_356_749_648
