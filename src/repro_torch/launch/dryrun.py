"""The dry run in PyTorch: the port of ``repro/launch/dryrun.py``.

Builds every (architecture × input shape) step on the ``meta`` device
(shapes only: nothing is allocated, nothing is drawn, nothing computed)
and runs it once under ``roofline/trace.py::StepTrace``, which counts its
dot FLOPs, dot bytes and peak live bytes; then records the reference's
``memory_analysis()`` fields and the roofline terms on one H100
(``roofline/terms.py``). The reference lowers and compiles each step for a
256-chip mesh; one card has no mesh, so every record is for one card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape train_4k [--out results/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

It needs no card. The steps are the port's own entry points: ``train`` is
``launch/train.py::train_step`` (``Model.loss`` with remat, its backward,
``adamw_update``), ``prefill`` is ``Model.forward`` and ``decode`` is
``Model.decode_step`` against ``init_decode_state``. On ``meta`` every
kernel dispatcher takes its plain version, as for any tensor that is not
on the card, so the counts are those of the plain path; the same ``build``
gives the step on a card (``build(..., device="cuda")``), which is how
``chip_smoke.py`` holds a trace to the card.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch.train import train_step
from repro_torch.models.config import ALL_SHAPES, InputShape, ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.roofline.terms import roofline_terms
from repro_torch.roofline.trace import StepTrace, tensor_bytes

DRY_ARCHS = tuple(a for a in ARCHS if a != "waste-pipeline")
MESH = "1xH100"
NO_MESH = "one card has no production mesh: the dry run is for one H100"
#: the reference's collective bytes of a program with no collective
NO_COLLECTIVES = {"all-gather": 0.0, "all-reduce": 0.0,
                  "reduce-scatter": 0.0, "all-to-all": 0.0,
                  "collective-permute": 0.0, "total_wire_bytes": 0.0}


def _shape_by_name(name: str) -> InputShape:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def _batch(cfg: ModelConfig, shape: InputShape, device) -> dict:
    """``make_batch_specs``'s inputs on ``device``: the stand-ins
    themselves on ``meta``, else drawn from seed 0 at their shapes and
    dtypes (tokens and labels in the vocabulary, media N(0, 1))."""
    specs = make_batch_specs(cfg, shape)
    if torch.device(device).type == "meta":
        return specs
    g = torch.Generator(device).manual_seed(0)
    return {k: torch.randn(v.shape, generator=g, device=device).to(v.dtype)
            if v.is_floating_point() else
            torch.randint(0, cfg.vocab_size, v.shape, generator=g,
                          device=device, dtype=v.dtype)
            for k, v in specs.items()}


def _model(cfg, device, backend) -> Model:
    return Model(cfg, device=device, backend=backend, init_device=device)


# ---------------------------------------------------------------------------
# Steps: each ``build_*`` returns (step, args); ``step()`` runs the step
# once and returns what the reference's jitted step returns, ``args`` its
# arguments.
# ---------------------------------------------------------------------------

def build_train(cfg: ModelConfig, shape: InputShape, device="meta",
                backend: str = "auto"):
    model = _model(cfg, device, backend).requires_grad_(True)
    opt_cfg = AdamWConfig(total_steps=1000)
    opt = adamw_init(model)
    batch = _batch(cfg, shape, device)
    params = dict(model.named_parameters())

    def step():
        loss, _ = train_step(model, opt_cfg, opt, batch)
        return params, opt, loss

    return step, (params, opt, batch)


def build_prefill(cfg: ModelConfig, shape: InputShape, device="meta",
                  backend: str = "auto"):
    model = _model(cfg, device, backend)
    batch = _batch(cfg, shape, device)

    @torch.no_grad()
    def step():
        logits, _ = model(batch)
        return logits

    return step, (dict(model.named_parameters()), batch)


def build_decode(cfg: ModelConfig, shape: InputShape, device="meta",
                 backend: str = "auto"):
    model = _model(cfg, device, backend)
    state = model.init_decode_state(shape.global_batch, shape.seq_len)
    tokens = _batch(cfg, shape, device)["tokens"]

    @torch.no_grad()
    def step():
        return model.decode_step(state, tokens)

    return step, (dict(model.named_parameters()), state, tokens)


def build(cfg: ModelConfig, shape: InputShape, device="meta",
          backend: str = "auto"):
    """(step, args) of ``shape.kind`` for ``cfg`` on ``device``; the model
    takes ``backend`` and draws its weights from seed 0 on ``device``
    (nothing is drawn on ``meta``)."""
    make = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}[shape.kind]
    return make(cfg, shape, device, backend)


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

def dry_run_one(arch: str, shape: str | InputShape, *,
                multi_pod: bool = False,
                out_dir: str | None = "results/dryrun",
                verbose: bool = True) -> dict:
    """Trace one step of ``arch`` (its full config) at ``shape`` (a name of
    ``ALL_SHAPES`` or an ``InputShape``) on ``meta``; returns the record
    and writes it to ``out_dir`` (None or '' writes nothing)."""
    if multi_pod:
        raise ValueError(NO_MESH)
    cfg = get_config(arch)
    shape = _shape_by_name(shape) if isinstance(shape, str) else shape
    t0 = time.time()
    step, args = build(cfg, shape)
    with StepTrace(args) as tr:
        out_bytes = tensor_bytes(step())
    t_trace = time.time() - t0
    counts = tr.counts()
    arg_bytes = float(tensor_bytes(args))
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": MESH,
        "n_chips": 1,
        "lower_s": round(t_trace, 2),
        "compile_s": 0.0,
        "hlo_flops_raw_per_chip": counts["dot_flops"],
        "hlo_bytes_raw_per_chip": counts["dot_bytes"],
        "collectives": dict(NO_COLLECTIVES),
        "arg_bytes_global": arg_bytes,
        "memory": {
            "argument_size_in_bytes": counts["arg_bytes"],
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": counts["temp_bytes"],
            "generated_code_size_in_bytes": 0,
            "peak_size_in_bytes": counts["peak_bytes"],
        },
        "roofline": roofline_terms(cfg, shape, counts, arg_bytes),
    }
    tag = f"{arch}__{shape.name}__{MESH}"
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(record, f, indent=1)
    if verbose:
        r = record["roofline"]
        print(
            f"[dryrun] {tag}: trace={record['lower_s']:.1f}s "
            f"flops={r['hlo_flops_per_chip']:.3e} "
            f"compute={r['compute_s']:.2e}s memory={r['memory_s']:.2e}s "
            f"-> {r['bottleneck']} useful={r['useful_flops_ratio']:.2f} "
            f"peak={counts['peak_bytes'] / 1e9:.1f}GB", flush=True
        )
    return record


def table(records: list) -> str:
    """``records`` as a markdown table, one row a record: dot and model
    TFLOP, the useful ratio, the roofline terms, the argument and traced
    peak GB."""
    lines = ["| arch | shape | dot TFLOP | model TFLOP | useful | compute s "
             "| memory s | bottleneck | argument GB | traced peak GB |",
             "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |"]

    def num(x: float) -> str:
        return f"{x:,.0f}" if x >= 1000 else f"{x:.4g}"

    for r in records:
        t = r["roofline"]
        cells = [r["arch"], r["shape"], num(t["hlo_flops_per_chip"] / 1e12),
                 num(t["model_flops"] / 1e12),
                 f"{t['useful_flops_ratio']:.3f}", num(t["compute_s"]),
                 num(t["memory_s"]), t["bottleneck"],
                 num(r["arg_bytes_global"] / 1e9),
                 num(r["memory"]["peak_size_in_bytes"] / 1e9)]
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: one card has no production mesh")
    ap.add_argument("--all", action="store_true",
                    help="every arch but waste-pipeline x every shape, then "
                         "their records as a markdown table")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise ValueError(NO_MESH)

    if args.all:
        t0 = time.time()
        failures, records = [], []
        for arch in DRY_ARCHS:
            for shape in ALL_SHAPES:
                try:
                    records.append(dry_run_one(arch, shape.name,
                                               out_dir=args.out))
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape.name, repr(e)))
                    traceback.print_exc()
        if failures:
            print("FAILURES:", failures)
            raise SystemExit(1)
        print(table(records))
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        print(f"all {len(DRY_ARCHS) * len(ALL_SHAPES)} combos traced OK in "
              f"{time.time() - t0:.1f} s, host peak RSS {rss / 1e6:.2f} GB")
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    rec = dry_run_one(args.arch, args.shape, out_dir=args.out)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
