"""The port's dry run (``repro_torch.launch.dryrun``), its pieces and the
analysis CLI's report, against the JAX package where it has them.

- ``make_batch_specs``: the reference's keys, shapes and dtype names, for
  every arch x ``ALL_SHAPES``, every stand-in on ``meta``;
- ``model_flops``: equal to ``repro.roofline.hlo.model_flops`` for every
  arch x shape; ``roofline_terms``: the reference's keys, one card, no
  collective, the bottleneck the larger term;
- ``StepTrace``: FLOPs by ``torch.utils.flop_counter``'s formulas (equal to
  ``FlopCounterMode``'s total), dot bytes, live bytes with a view's storage
  once and a freed storage gone; a step traced on ``meta`` gives the
  counts and the peak of the same step run on the CPU;
- ``Model`` on ``meta``: the full kimi-k2-1t-a32b (1.03 T parameters)
  builds with every parameter there, drawing nothing; a CPU-built model
  draws the weights it drew before the meta build existed (their SHA-256
  pinned from that code);
- Mamba-1's blocked scan (the ``meta`` route): the step-by-step oracle's
  values and gradients on the CPU, within 1e-5 of their max (measured
  ≤ 1e-6: the same f32 recurrence, its products in another order);
- full-size records on one card (``mesh="1xH100"``), one a family at
  ``DECODE_32K`` (a second's trace each): the reference's record keys,
  ``collective_s`` 0, a bottleneck; the CLI writes its record
  (``--single-card``); ``--multi-pod`` gives the 2 x 16 x 16 record, one
  rank's counts with a collective term, and refuses ``--single-card``;
- the analysis CLI writes ``analysis_report.json`` under ``--report-dir``
  and takes fixtures from ``REPRO_ANALYSIS_FIXTURE`` (``race`` fails it).

The traced counts against the reference's compiled HLO:
``test_torch_dryrun_counts.py`` and ``test_torch_dryrun_train_counts.py``.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as configs_j
import repro.models.config as config_j
from repro.data.pipeline import make_batch_specs as batch_specs_j
from repro.roofline.hlo import model_flops as model_flops_j
from repro.roofline.hlo import roofline_terms as roofline_terms_j
import repro_torch.configs as configs_t
from repro_torch.analysis import cli as analysis_cli
from repro_torch.data import make_batch_specs
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.launch import dryrun
from repro_torch.models.config import ALL_SHAPES, DECODE_32K, InputShape
from repro_torch.models.ssm import _selective_scan_blocked
from repro_torch.models.transformer import Model
from repro_torch.roofline.terms import model_flops, roofline_terms
from repro_torch.roofline.trace import StepTrace

SHAPE_NAMES = [s.name for s in ALL_SHAPES]


def _shape_j(name):
    return next(s for s in config_j.ALL_SHAPES if s.name == name)


def _shape_t(name):
    return next(s for s in ALL_SHAPES if s.name == name)


# ---------------------------------------------------------------------------
# make_batch_specs, model_flops, roofline_terms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", configs_t.ARCHS)
def test_batch_specs_match_the_reference(arch, shape):
    want = batch_specs_j(configs_j.get_config(arch), _shape_j(shape))
    got = make_batch_specs(configs_t.get_config(arch), _shape_t(shape))
    assert list(got) == list(want)
    for k, spec in want.items():
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == \
            jnp.dtype(spec.dtype).name, k
        assert got[k].is_meta, k


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", configs_t.ARCHS)
def test_model_flops_equal_the_reference(arch, shape):
    want = model_flops_j(configs_j.get_config(arch), _shape_j(shape))
    assert model_flops(configs_t.get_config(arch), _shape_t(shape)) == want


def test_roofline_terms_have_the_reference_keys():
    cfg_t = configs_t.get_config("qwen2.5-3b")
    cfg_j = configs_j.get_config("qwen2.5-3b")
    analysis = {"weighted_dot_flops": 1e15, "weighted_dot_bytes": 1e9,
                "collectives_weighted": {"total_wire_bytes": 0.0}}
    want = roofline_terms_j(cfg_j, _shape_j("train_4k"), 1, analysis, 3e10)
    got = roofline_terms(cfg_t, _shape_t("train_4k"),
                         {"dot_flops": 1e15, "dot_bytes": 1e9}, 3e10)
    assert list(got) == list(want)
    assert got["collective_s"] == 0.0 and got["wire_bytes_per_chip"] == 0.0
    assert got["compute_s"] == 1e15 / 989e12          # bf16 on one H100
    assert got["memory_s"] == (3e10 + 1e9) / 3.35e12
    assert got["bottleneck"] == "compute"
    assert got["useful_flops_ratio"] == want["model_flops"] / 1e15
    f32 = roofline_terms(configs_t.reduced(cfg_t), _shape_t("decode_32k"),
                         {"dot_flops": 67e9, "dot_bytes": 0.0}, 6.7e12)
    assert f32["compute_s"] == 1e-3 and f32["bottleneck"] == "memory"


# ---------------------------------------------------------------------------
# StepTrace
# ---------------------------------------------------------------------------

def test_trace_counts_live_storages_once_and_frees_them():
    a = torch.empty((256, 64), device="meta")             # 64 KiB
    w = torch.empty((64, 32), device="meta")              # 8 KiB
    with StepTrace((a, w)) as tr:
        assert tr.arg_bytes == 65536 + 8192
        v = a[:128]                                      # a view: no bytes
        assert tr.live_bytes == tr.arg_bytes
        b = a * 2.0                                      # +64 KiB
        y = v @ w                                        # +16 KiB
        del b
        z = (y + 1.0).sum()                               # +16 KiB, then 4 B
    assert tr.peak_bytes == 73728 + 65536 + 16384
    assert tr.dot_flops == 2 * 128 * 64 * 32
    assert tr.dot_bytes == 4 * (128 * 64 + 64 * 32 + 128 * 32)
    assert tr.counts()["temp_bytes"] == tr.peak_bytes - tr.arg_bytes
    del v, y, z


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "moonshot-v1-16b-a3b",
                                  "zamba2-7b", "seamless-m4t-medium"])
def test_meta_trace_is_the_cpu_run(arch, kind):
    """The same step on ``meta`` and on the CPU (the same plain routes):
    equal FLOPs, dot bytes, argument bytes and peak live bytes; and the
    FLOPs are ``FlopCounterMode``'s."""
    cfg = configs_t.reduced(configs_t.get_config(arch))
    shape = InputShape("t", 64, 2, kind)
    counts = []
    for device in ("meta", "cpu"):
        step, args = dryrun.build(cfg, shape, device=device)
        with StepTrace(args) as tr:
            step()
        counts.append(tr.counts())
    assert counts[0] == counts[1]
    step, _ = dryrun.build(cfg, shape, device="cpu")
    with FlopCounterMode(display=False) as fc:
        step()
    assert fc.get_total_flops() == counts[1]["dot_flops"]


# ---------------------------------------------------------------------------
# Model on meta
# ---------------------------------------------------------------------------

def test_kimi_k2_builds_on_meta_without_drawing():
    cfg = configs_t.get_config("kimi-k2-1t-a32b")
    model = Model(cfg, device="meta")
    params = list(model.parameters())
    assert all(p.is_meta for p in params)
    assert sum(p.numel() for p in params) == 1_028_298_994_688
    step, args = dryrun.build(cfg, DECODE_32K)
    assert all(t.is_meta for t in torch.utils._pytree.tree_leaves(args))


#: SHA-256 of the named parameters of ``Model(reduced(cfg), seed=3,
#: device="cpu")``, from the port before ``Model`` could be built on meta
WEIGHT_SHA256 = {
    "qwen2.5-3b":
        "c974ba06f452f3fefe2b8a5fb7ea9c791aee2086f8029fcfaa3843b781435d32",
    "zamba2-7b":
        "e7bfc4510202da49ac673c8d65df76662459d7da45e6aa3b5242e6572b230a95",
    "falcon-mamba-7b":
        "1587e607ec7d675f6de8c8d37742a17e0fb6f168d04f92f7fd5e9f30be6aea34",
    "moonshot-v1-16b-a3b":
        "4ef1158aeeaf73219018ec4a89bdc23a8384a8543c2817013f531c9432048e70",
    "deepseek-v2-236b":
        "67fe60ec3ba7cdfe722a4cd67ea0060c31baf7df33b22db01dcd24262650875e",
}


@pytest.mark.parametrize("arch", sorted(WEIGHT_SHA256))
def test_cpu_build_draws_the_same_weights(arch):
    model = Model(configs_t.reduced(configs_t.get_config(arch)), seed=3,
                  device="cpu")
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == WEIGHT_SHA256[arch]


# ---------------------------------------------------------------------------
# Mamba-1's blocked scan
# ---------------------------------------------------------------------------

def test_blocked_selective_scan_is_the_oracle():
    g = torch.Generator().manual_seed(0)
    B, S, di, N = 2, 64, 24, 16
    u = torch.randn(B, S, di, generator=g)
    dt = 0.1 * torch.rand(B, S, di, generator=g)
    A = -torch.rand(di, N, generator=g)
    Bm = torch.randn(B, S, N, generator=g)
    Cm = torch.randn(B, S, N, generator=g)
    ins = [t.requires_grad_() for t in (u, dt, A, Bm, Cm)]
    gy = torch.randn(B, S, di, generator=g)
    want = ssm_scan_ref(*ins)
    got = _selective_scan_blocked(*ins, 16)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    for gw, gg in zip(torch.autograd.grad(want, ins, gy),
                      torch.autograd.grad(got, ins, gy)):
        assert (gg - gw).abs().max() <= 1e-5 * gw.abs().max()


# ---------------------------------------------------------------------------
# full-size records and the CLI
# ---------------------------------------------------------------------------

RECORD_KEYS = ["arch", "shape", "mesh", "n_chips", "lower_s", "compile_s",
               "hlo_flops_raw_per_chip", "hlo_bytes_raw_per_chip",
               "collectives", "arg_bytes_global", "memory", "roofline"]
MEMORY_KEYS = ["argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes"]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "llava-next-34b",
                                  "moonshot-v1-16b-a3b", "deepseek-v2-236b",
                                  "seamless-m4t-medium", "falcon-mamba-7b",
                                  "zamba2-7b"])
def test_full_size_decode_record(arch):
    rec = dryrun.dry_run_one(arch, "decode_32k", mesh="1xH100",
                             out_dir=None, verbose=False)
    assert list(rec)[:len(RECORD_KEYS)] == RECORD_KEYS
    assert all(k in rec["memory"] for k in MEMORY_KEYS)
    assert rec["mesh"] == "1xH100" and rec["n_chips"] == 1
    assert rec["compile_s"] == 0.0
    assert rec["collectives"]["total_wire_bytes"] == 0.0
    roof = rec["roofline"]
    assert roof["collective_s"] == 0.0
    assert roof["bottleneck"] == ("compute" if roof["compute_s"]
                                  >= roof["memory_s"] else "memory")
    assert roof["hlo_flops_per_chip"] == rec["hlo_flops_raw_per_chip"] > 0
    assert rec["memory"]["argument_size_in_bytes"] == rec["arg_bytes_global"]
    assert rec["memory"]["temp_size_in_bytes"] >= 0


def test_cli_writes_a_record(tmp_path, capsys):
    dryrun.main(["--arch", "gemma2-2b", "--shape", "long_500k",
                 "--single-card", "--out", str(tmp_path)])
    path = tmp_path / "gemma2-2b__long_500k__1xH100.json"
    rec = json.loads(path.read_text())
    assert rec == json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert rec["roofline"]["bottleneck"] == "memory"
    header, rule, row = dryrun.table([rec]).split("\n")
    assert header.count("|") == rule.count("|") == row.count("|") == 13
    assert row.startswith("| gemma2-2b | long_500k | 1xH100 | ")
    assert row.endswith(" | memory | 61.06 | 61.12 |")


def test_multi_pod_raises(tmp_path):
    """``--multi-pod`` traces the 2 x 16 x 16 mesh (512 ranks under a fake
    group) and refuses ``--single-card`` beside it; the record is one
    rank's."""
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                     "--multi-pod", "--single-card", "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="exclude"):
        dryrun.dry_run_one("qwen2.5-3b", "decode_32k", multi_pod=True,
                           mesh="1xH100", out_dir=None)
    assert not list(tmp_path.iterdir())
    # a process group is global: the fake one is set up in a process of
    # its own
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).parent.parent / "src"),
         os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2.5-3b", "--shape", "decode_32k", "--multi-pod", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    rec = json.loads(
        (tmp_path / "qwen2.5-3b__decode_32k__2x16x16.json").read_text())
    one = dryrun.dry_run_one("qwen2.5-3b", "decode_32k", mesh="1xH100",
                             out_dir=None, verbose=False)
    assert rec["mesh"] == "2x16x16" and rec["n_chips"] == 512
    assert rec["arg_bytes_global"] == one["arg_bytes_global"]
    # batch 128 over pod x data (32), kv heads (2) do not divide model:
    # the cache shards its sequence; a chip holds 1/512 of it
    mem = rec["memory"]["argument_size_in_bytes"]
    assert one["arg_bytes_global"] / 512 < mem < one["arg_bytes_global"] / 32
    assert 0 < rec["hlo_flops_raw_per_chip"] < one["hlo_flops_raw_per_chip"]
    coll = rec["collectives"]
    assert coll["total_wire_bytes"] == sum(
        v for k, v in coll.items() if k != "total_wire_bytes") > 0
    roof = rec["roofline"]
    assert roof["collective_s"] > 0
    assert roof["model_flops_per_chip"] == roof["model_flops"] / 512
    assert roof["arg_bytes_per_chip"] == rec["arg_bytes_global"] / 512


# ---------------------------------------------------------------------------
# the analysis CLI's report
# ---------------------------------------------------------------------------

def test_analysis_cli_writes_its_report(tmp_path, monkeypatch):
    monkeypatch.delenv(analysis_cli.ENV_FIXTURE, raising=False)
    assert analysis_cli.main(["--report-dir", str(tmp_path)]) == 0
    report = json.loads((tmp_path / "analysis_report.json").read_text())
    assert report["ok"] is True and report["fixtures"] == []
    assert report["geometry"]["n_violations"] == 0
    assert "lint" not in report


def test_analysis_cli_reads_env_fixtures(tmp_path, monkeypatch):
    monkeypatch.setenv(analysis_cli.ENV_FIXTURE, " race, oob")
    assert analysis_cli.main(["--fixture", "alias", "--report-dir",
                              str(tmp_path)]) == 1
    report = json.loads((tmp_path / "analysis_report.json").read_text())
    assert report["ok"] is False
    assert report["fixtures"] == ["alias", "race", "oob"]
    kinds = {v["kind"] for v in report["geometry"]["violations"]}
    assert len(kinds) == 3
    monkeypatch.setenv(analysis_cli.ENV_FIXTURE, "nonesuch")
    with pytest.raises(ValueError, match="unknown fixture"):
        analysis_cli.main(["--report-dir", ""])
