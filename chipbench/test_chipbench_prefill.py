"""The model prefill cell on the CPU at a tiny size: a cell of new files
runs through the harness on the port's plain path and reports the prefill
metrics; the seed fixes the prompts; the plain reference is the port's
forward; the pool's schedule; the control and faults planted under the
timed path come out not correct; the FLOP count is ``FlopCounterMode``'s;
the readers read what a traced slice gives them and nothing of another
cell's.

The cell runs on one chip, so the fault "the exchange between chips
left out" has no path to break here, and a prefill holds no state that
a step could leave unchanged."""

import dataclasses
import importlib.util
import itertools
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from chipbench import harness, peaks
from chipbench.counts import dense_decoder as count
from chipbench.drivers import model_prefill
from chipbench.reference import dense_decoder as ref

METRICS = Path(__file__).resolve().parent / "metrics"
SEED = 2**31 + 21


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tiny runs share the machine with other
    test workers, and a window of a few seconds has to send the sampled
    prompts, which lie in the first steps."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(root, cell, program=None, seed=SEED, trace=False):
    return harness.run_cell(root, cell, seed=seed, seconds=3.0,
                            trace=trace, device="cpu",
                            t_start=time.perf_counter(), program=program)


def _spec(tiny_model):
    root, cell = tiny_model
    spec = harness.cell_spec(root, cell)
    return spec["config"], spec["traffic"]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name.replace('.', '_')}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_tiny_prefill_cell_runs_on_the_plain_path(tiny_model):
    line = _run(*tiny_model)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) == {"row_err_max", "logit_gap_max",
                                   "sampled_not_sent"}
    assert list(line)[-1] == "checks"
    spec = harness.cell_spec(*tiny_model)
    assert {m["name"] for m in spec["per_layer"]} == {
        "prefill_mfu", "flash_attention_roofline",
        "device_idle_share.prefill"}


def test_the_fleet_tiny_cell_still_reports_the_fleet_metrics(tiny):
    spec = harness.cell_spec(*tiny)
    assert {m["name"] for m in spec["end_to_end"]} == {
        "replica_frames_per_s", "setup_s"}


def test_the_same_seed_gives_the_same_prompts(tiny_model):
    config, traffic = _spec(tiny_model)

    def draw(seed):
        w, lengths, tokens, batch, sampled = model_prefill.inputs(
            config, traffic, ref, seed, "cpu")
        return (lengths, [tokens(i) for i in range(len(lengths))],
                sampled, w["embed"])

    a, b, c = draw(SEED), draw(SEED), draw(SEED + 1)
    assert np.array_equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert a[2] == b[2] and torch.equal(a[3], b[3])
    assert not np.array_equal(a[0], c[0])
    assert any(x.shape != y.shape or not torch.equal(x, y)
               for x, y in zip(a[1], c[1]))
    # every seed sends the same lengths, in its own order
    assert sorted(a[0]) == sorted(c[0])


def test_the_lengths_are_the_traffics():
    traffic = json.loads((Path(__file__).resolve().parent / "traffic"
                          / "prefill-mixed.json").read_text())
    lengths = model_prefill.prompt_lengths(traffic, SEED)
    assert len(lengths) == 2048
    assert lengths.min() == 256 and lengths.max() == 8192
    assert (lengths % 256 == 0).all()
    block = np.sort(lengths[:64])
    # the trace's median of 1,500 tokens, at its 256-token bucket
    assert np.median(block) == 1536
    for k in range(32):
        assert np.array_equal(np.sort(lengths[64 * k:64 * (k + 1)]), block)
    picked = model_prefill.sample(lengths, traffic, SEED)
    assert 6 <= len(picked) <= 10
    assert lengths[[k % 2048 for k in picked]].max() == 8192
    assert int(np.argmax(lengths)) in picked


@pytest.mark.parametrize("seed", [SEED, 7, 2**31 + 4093])
def test_the_schedule_batches_the_oldest_prompt_with_its_length(seed):
    """Each step holds the oldest waiting prompt and the next waiting
    ones of its length, ``step_tokens // S`` of them; no prompt is sent
    twice, and every one is sent in turn."""
    traffic = json.loads((Path(__file__).resolve().parent / "traffic"
                          / "prefill-mixed.json").read_text())
    lengths = model_prefill.prompt_lengths(traffic, seed)
    budget = traffic["step_tokens"]
    schedule = model_prefill.Schedule(lengths, budget)
    assert sorted(S for _, S in schedule.shapes()) == sorted(
        set(lengths.tolist()))
    sent = set()
    for S, ids in itertools.islice(schedule, 400):
        head = min(set(range(max(sent | {0}) + 2)) - sent)
        assert ids[0] == head
        assert len(ids) == budget // S and len(ids) * S <= budget
        assert all(lengths[k % len(lengths)] == S for k in ids)
        assert ids == sorted(ids) and not sent & set(ids)
        # no waiting prompt of this length was passed over
        assert all(lengths[k % len(lengths)] != S
                   for k in range(ids[0], ids[-1]) if k not in ids
                   and k not in sent)
        sent |= set(ids)
    assert set(range(2048)) <= sent


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_reference_is_the_ports_forward(tiny_model, dtype):
    """The port's forward on the CPU against the reference on the same
    weights: in float32 to rounding, in bfloat16 within the limits."""
    from repro_torch.models.transformer import Model

    config, traffic = _spec(tiny_model)
    config = dict(config, torch_dtype=dtype)
    weights, lengths, tokens, batch, _ = model_prefill.inputs(
        config, traffic, ref, SEED, "cpu")
    model = Model(model_prefill.port_config(config), device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
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


def test_the_control_is_not_correct(tiny_model):
    line = _run(*tiny_model, program="control")
    assert line["correct"] is False
    assert line["checks"]["row_err_max"]["value"] > \
        line["checks"]["row_err_max"]["limit"]


def _qkv_bias_left_out(monkeypatch):
    from repro_torch.models import layers

    real = layers._qkv

    def no_bias(p, *a, **k):
        return real({n: w for n, w in p.items()
                     if n not in ("bq", "bk", "bv")}, *a, **k)

    monkeypatch.setattr(layers, "_qkv", no_bias)


def _rope_theta_1e4(monkeypatch):
    from repro_torch.models import layers

    real = layers.apply_rope
    monkeypatch.setattr(layers, "apply_rope",
                        lambda x, positions, theta: real(x, positions, 1e4))


def _block_outputs_in_fp8(monkeypatch):
    """Every block's output rounded to float8_e4m3fn, where it is made."""
    from repro_torch.models import transformer

    real = transformer.DecoderBlock.forward

    def rounded(self, *a, **k):
        x, aux = real(self, *a, **k)
        return x.to(torch.float8_e4m3fn).to(x.dtype), aux

    monkeypatch.setattr(transformer.DecoderBlock, "forward", rounded)


def _last_answer_from_the_position_before(monkeypatch):
    """The last position's logits, the answer a prefill serves, altered
    where they are produced: the position before it given instead."""
    from repro_torch.models import transformer

    real = transformer.Model._logits

    def shifted(self, x):
        out = real(self, x)
        return torch.cat([out[:, :-1], out[:, -2:-1]], dim=1)

    monkeypatch.setattr(transformer.Model, "_logits", shifted)


def _half_the_batch_left_out(monkeypatch):
    """A step runs the first half of its rows and gives the rest the
    mean of their logits."""
    from repro_torch.models import transformer

    real = transformer.Model.forward

    def half(self, batch, *a, **k):
        t = batch["tokens"]
        h = (t.shape[0] + 1) // 2
        logits, aux = real(self, dict(batch, tokens=t[:h]), *a, **k)
        rest = logits.mean(0, keepdim=True).expand(
            t.shape[0] - h, *logits.shape[1:])
        return torch.cat([logits, rest]), aux

    monkeypatch.setattr(transformer.Model, "forward", half)


@pytest.mark.parametrize("plant", [
    _qkv_bias_left_out, _rope_theta_1e4, _block_outputs_in_fp8,
    _last_answer_from_the_position_before, _half_the_batch_left_out],
    ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_is_not_correct(tiny_model, monkeypatch, plant):
    plant(monkeypatch)
    line = _run(*tiny_model)
    assert line["correct"] is False
    assert line["failed"] > 0


def test_device_metrics_without_a_card_fail(tiny_model):
    if torch.cuda.is_available():
        pytest.skip("this test checks a machine without a card")
    with pytest.raises((RuntimeError, AssertionError)):
        _run(*tiny_model, trace=True)


@pytest.mark.parametrize("B, S", [(1, 8), (3, 24), (2, 40)])
def test_the_flop_count_is_flop_counter_modes(tiny_model, B, S):
    """The port's forward on the CPU computes attention as a masked
    dense product, so ``FlopCounterMode`` counts all S^2 pairs there,
    and the logits at every position."""
    from repro_torch.models.transformer import Model

    config, traffic = _spec(tiny_model)
    cfg = model_prefill.port_config(config)
    model = Model(cfg, seed=3, device="cpu")
    tokens = torch.arange(B * S).view(B, S) % config["vocab_size"]
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model({"tokens": tokens})
    dense = B * (count.layer_flops(config, S) + count.logit_flops(config, S)
                 + count.attention_flops(config, S, causal=False))
    assert fc.get_total_flops() == dense
    # the model FLOPs: causal pairs, the logits at the last position only
    assert count.forward_flops(config, S, B) == dense - B * (
        count.logit_flops(config, S - 1)
        + count.attention_flops(config, S, causal=False)
        - count.attention_flops(config, S))


def test_the_attention_count_at_a_few_lengths():
    config = json.loads((Path(__file__).resolve().parent / "configs"
                         / "qwen2.5-3b.json").read_text())
    for S in (1, 2, 7, 256):
        mask = torch.ones(S, S).tril()
        assert count.causal_pairs(S) == int(mask.sum())
        for B in (1, 3):
            launches = count.attention_launches(config, S, B)
            assert len(launches) == 36
            assert launches[0] == (B * 4 * 16 * 128 * count.causal_pairs(S),
                                   B * 2 * 128 * S * (16 + 2 + 2 + 16))
    # a 1,536-token prompt: compute bound, 9.67 GFLOP a launch
    ops, nbytes = count.attention_launches(config, 1536)[0]
    assert ops == 9_669_967_872
    assert ops / peaks.BF16_FLOP_PER_S > nbytes / peaks.HBM_BYTES_PER_S
    # ~5.55 GFLOP a token in the layers, 0.62 for one position's logits,
    # causal attention on top
    assert count.layer_flops(config, 1) == 5_549_064_192
    assert count.logit_flops(config, 1) == 622_329_856
    assert count.forward_flops(config, 8192, 2) == 2 * (
        count.layer_flops(config, 8192) + count.logit_flops(config, 1)
        + 36 * 4 * 2048 * count.causal_pairs(8192))


def _prefill_ctx(config, traced, n_attn, attn_s, busy_s=0.8, wall_s=1.0,
                 untraced=((10, 1536), (64, 256)), untraced_s=2.0):
    name = "void flash_attention_wgmma_kernel<128>(CUtensorMap)"
    return {"trace": {"wall_s": wall_s, "busy_s": busy_s, "device_ops": 9,
                      "by_name": {name: {"count": n_attn,
                                         "seconds": attn_s}}},
            "prefill": {"config": config, "count": "dense_decoder",
                        "traced_steps": [list(s) for s in traced],
                        "untraced_steps": [list(s) for s in untraced],
                        "untraced_s": untraced_s}}


def test_the_prefill_readers():
    config = json.loads((Path(__file__).resolve().parent / "configs"
                         / "qwen2.5-3b.json").read_text())
    ctx = _prefill_ctx(config, [(10, 1536), (64, 256)], 72, 2e-3)
    # the MFU reads the steps outside the traced slice, over their time
    flops = count.forward_flops(config, 1536, 10) + count.forward_flops(
        config, 256, 64)
    assert _reader("prefill_mfu").read(ctx) == pytest.approx(
        100 * flops / (2.0 * peaks.BF16_FLOP_PER_S))
    bound = 36 * sum(max(ops / peaks.BF16_FLOP_PER_S,
                         b / peaks.HBM_BYTES_PER_S) for ops, b in (
        count.attention_launches(config, 1536, 10)[0],
        count.attention_launches(config, 256, 64)[0]))
    assert _reader("flash_attention_roofline").read(ctx) == pytest.approx(
        100 * bound / 2e-3)
    assert _reader("device_idle_share.prefill").read(ctx) == \
        pytest.approx(20.0)
    # launches that are not one a layer of each traced step: no reading
    assert _reader("flash_attention_roofline").read(
        _prefill_ctx(config, [(10, 1536), (64, 256)], 71, 2e-3)) is None
    # no step outside the slice: no MFU
    assert _reader("prefill_mfu").read(_prefill_ctx(
        config, [(10, 1536)], 36, 1e-3, untraced=(), untraced_s=0.0)) is None


@pytest.mark.parametrize("name", [
    "prefill_mfu", "flash_attention_roofline", "device_idle_share.prefill",
    "device_idle_share.fleet", "tick_device_ms", "tick_launches",
    "fused_place_roofline", "window_query_roofline"])
def test_a_reader_reads_nothing_of_another_cell(name):
    config = json.loads((Path(__file__).resolve().parent / "configs"
                         / "qwen2.5-3b.json").read_text())
    fleet_ctx = {"trace": {"wall_s": 1.0, "busy_s": 0.5, "device_ops": 0,
                           "launches": 0, "by_name": {}},
                 "ticks": 40, "fleet": {}}
    prefill_ctx = _prefill_ctx(config, [(64, 256)], 36, 1e-3)
    reads_prefill = name.startswith(("prefill", "flash", "device_idle_"
                                     "share.prefill"))
    other = fleet_ctx if reads_prefill else prefill_ctx
    assert _reader(name).read(other) is None
    assert _reader(name).read(None) is None


def test_the_port_config_is_the_published_one():
    """qwen2.5-3b's file sets the port's module's fields to what they
    already are: the cell runs the port's config as it stands."""
    from repro_torch.configs import qwen2_5_3b

    config = json.loads((Path(__file__).resolve().parent / "configs"
                         / "qwen2.5-3b.json").read_text())
    cfg = model_prefill.port_config(config)
    assert cfg == qwen2_5_3b.CONFIG
    assert dataclasses.asdict(cfg)["sliding_window"] == 0
