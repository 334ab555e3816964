"""The dry run in PyTorch: the port of ``repro/launch/dryrun.py``.

Builds every (architecture × input shape) step on the ``meta`` device
(shapes only: nothing is allocated, nothing is drawn, nothing computed)
and runs it once under ``roofline/trace.py::StepTrace``, which counts the
dot FLOPs, dot bytes, collectives and peak live bytes of one rank; then
records the reference's ``memory_analysis()`` fields and the roofline
terms per H100 (``roofline/terms.py``).

By default the step runs, as in the reference, on the production mesh:
16 x 16 = 256 ranks, or 2 x 16 x 16 = 512 with ``--multi-pod``, under a
fake process group (``torch.testing._internal.distributed.fake_pg``: each
collective is counted and moves nothing) that ``dry_run_one`` sets up and
tears down, so one process can trace both meshes in turn. The parameters,
moments, batch and decode state are DTensors placed by
``launch/sharding.py`` (``pick_strategy``, both ``configure_*`` hints);
the counts are rank 0's. ``--single-card`` (``mesh="1xH100"``) traces the
step on one card, with no mesh and no collective.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape train_4k [--multi-pod | --single-card] [--out results/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

It needs no card. The steps are the port's own entry points: ``train`` is
``launch/train.py::train_step`` (``Model.loss`` with remat, its backward,
``adamw_update``), ``prefill`` is ``Model.forward`` and ``decode`` is
``Model.decode_step`` against ``init_decode_state``. On ``meta`` every
kernel dispatcher takes its plain version, as for any tensor that is not
on the card, so the counts are those of the plain path; the same ``build``
gives the step on a card (``build(..., device="cuda")``, with a mesh or
without), which is how ``chip_smoke.py`` holds a trace to the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import resource
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import spmd
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import sharding
from repro_torch.launch.mesh import (
    AbstractMesh,
    make_mesh,
    mesh_label,
    production_shape,
)
from repro_torch.launch.train import place_on_mesh, train_step
from repro_torch.models.config import ALL_SHAPES, InputShape, ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.roofline.terms import roofline_terms
from repro_torch.roofline.trace import StepTrace, local_bytes, tensor_bytes

DRY_ARCHS = tuple(a for a in ARCHS if a != "waste-pipeline")
#: the label of a record for one card, with no mesh
SINGLE_CARD = "1xH100"


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


def _shapes(model: Model) -> dict:
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# Steps: each ``build_*`` returns (step, args); ``step()`` runs the step
# once and returns what the reference's jitted step returns, ``args`` its
# arguments. With a ``mesh`` (a ``DeviceMesh``) the arguments are DTensors
# placed by ``launch/sharding.py``.
# ---------------------------------------------------------------------------

def build_train(cfg: ModelConfig, shape: InputShape, device="meta",
                backend: str = "auto", mesh=None):
    model = _model(cfg, device, backend).requires_grad_(True)
    opt_cfg = AdamWConfig(total_steps=1000)
    batch = _batch(cfg, shape, device)
    if mesh is not None:
        opt, place_batch = place_on_mesh(mesh, cfg, model)
        batch = place_batch(batch)
    else:
        opt = adamw_init(model)
    params = dict(model.named_parameters())

    def step():
        loss, _ = train_step(model, opt_cfg, opt, batch)
        return params, opt, loss

    return step, (params, opt, batch)


def build_prefill(cfg: ModelConfig, shape: InputShape, device="meta",
                  backend: str = "auto", mesh=None):
    model = _model(cfg, device, backend)
    batch = _batch(cfg, shape, device)
    if mesh is not None:
        spmd.distribute_model(model, mesh, sharding.param_specs(
            mesh, cfg, _shapes(model), phase="prefill"))
        batch = spmd.distribute_tree(batch, mesh, sharding.batch_specs(
            mesh, cfg, shape, batch))

    @torch.no_grad()
    def step():
        logits, _ = model(batch)
        return logits

    return step, (dict(model.named_parameters()), batch)


def build_decode(cfg: ModelConfig, shape: InputShape, device="meta",
                 backend: str = "auto", mesh=None):
    model = _model(cfg, device, backend)
    state = model.init_decode_state(shape.global_batch, shape.seq_len)
    tokens = _batch(cfg, shape, device)["tokens"]
    if mesh is not None:
        spmd.distribute_model(model, mesh, sharding.param_specs(
            mesh, cfg, _shapes(model), phase="decode"))
        state = spmd.distribute_tree(state, mesh,
                                         sharding.decode_state_specs(
                                             mesh, cfg, shape, state))
        tokens = spmd.distribute(tokens, mesh, sharding.batch_specs(
            mesh, cfg, shape, {"t": tokens})["t"])

    @torch.no_grad()
    def step():
        return model.decode_step(state, tokens)

    return step, (dict(model.named_parameters()), state, tokens)


def build(cfg: ModelConfig, shape: InputShape, device="meta",
          backend: str = "auto", mesh=None):
    """(step, args) of ``shape.kind`` for ``cfg`` on ``device``; the model
    takes ``backend`` and draws its weights from seed 0 on ``device``
    (nothing is drawn on ``meta``). With ``mesh`` (a ``DeviceMesh``), the
    reference's ``build``: the strategy, the placements of the
    parameters, moments, batch and decode state, and both activation
    hints (``launch/sharding.py``); without, the hints are reset."""
    if mesh is not None:
        sharding.configure_attention_sharding(mesh, cfg, shape.kind)
        sharding.configure_moe_sharding(mesh, cfg)
    else:
        reset_hints(cfg, shape)
    make = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}[shape.kind]
    return make(cfg, shape, device, backend, mesh)


def reset_hints(cfg, shape) -> None:
    """Both activation hints at their values without a mesh."""
    one = AbstractMesh((1,), ("data",))
    sharding.configure_attention_sharding(one, cfg, shape.kind)
    sharding.configure_moe_sharding(one, cfg)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    for as long as the block runs; its collectives move nothing. Refuses
    to replace a group that is already initialised."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    # DTensor warns at each gather over two mesh dims; the trace counts them
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_step(cfg: ModelConfig, shape: InputShape, mesh=None):
    """Trace one step of ``cfg`` at ``shape`` on ``meta``, on one card
    (``mesh`` None) or on a mesh of that shape (an ``AbstractMesh``)
    under a fake process group. Returns (counts of rank 0, its output
    bytes, the global argument bytes)."""
    if mesh is None:
        ctx, dmesh = contextlib.nullcontext(), None
    else:
        ctx = fake_group(math.prod(mesh.sizes))
    with ctx:
        if mesh is not None:
            dmesh = make_mesh(mesh.sizes, mesh.names)
        try:
            step, args = build(cfg, shape, mesh=dmesh)
            with StepTrace(args) as tr:
                out_bytes = local_bytes(step())
        finally:
            reset_hints(cfg, shape)
    return tr.counts(), out_bytes, float(tensor_bytes(args))


def _mesh_of(mesh, multi_pod: bool):
    """(label, AbstractMesh or None) of ``dry_run_one``'s mesh."""
    if mesh == SINGLE_CARD:
        if multi_pod:
            raise ValueError("multi_pod and a single card exclude each other")
        return SINGLE_CARD, None
    if mesh is None:
        mesh = production_shape(multi_pod)
    elif multi_pod:
        raise ValueError("multi_pod names the production mesh; pass one or "
                         "the other")
    return mesh_label(mesh), mesh


def dry_run_one(arch: str, shape: str | InputShape, *,
                multi_pod: bool = False, mesh=None,
                out_dir: str | None = "results/dryrun",
                verbose: bool = True) -> dict:
    """Trace one step of ``arch`` (its full config) at ``shape`` (a name of
    ``ALL_SHAPES`` or an ``InputShape``) on ``meta``; returns the record
    and writes it to ``out_dir`` (None or '' writes nothing).

    ``mesh`` None: the production mesh, 16 x 16 (2 x 16 x 16 with
    ``multi_pod``); an ``AbstractMesh``: that mesh; ``"1xH100"``: one
    card, no mesh. On a mesh the counts are one rank's."""
    label, amesh = _mesh_of(mesh, multi_pod)
    n_chips = 1 if amesh is None else math.prod(amesh.sizes)
    cfg = get_config(arch)
    shape = _shape_by_name(shape) if isinstance(shape, str) else shape
    t0 = time.time()
    counts, out_bytes, arg_bytes = trace_step(cfg, shape, amesh)
    t_trace = time.time() - t0
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": label,
        "n_chips": n_chips,
        "lower_s": round(t_trace, 2),
        "compile_s": 0.0,
        "hlo_flops_raw_per_chip": counts["dot_flops"],
        "hlo_bytes_raw_per_chip": counts["dot_bytes"],
        "collectives": counts["collectives"],
        "arg_bytes_global": arg_bytes,
        "memory": {
            "argument_size_in_bytes": counts["arg_bytes"],
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": counts["temp_bytes"],
            "generated_code_size_in_bytes": 0,
            "peak_size_in_bytes": counts["peak_bytes"],
        },
        "roofline": roofline_terms(cfg, shape, counts, arg_bytes, n_chips),
    }
    tag = f"{arch}__{shape.name}__{label}"
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(record, f, indent=1)
    if verbose:
        r = record["roofline"]
        print(
            f"[dryrun] {tag}: trace={record['lower_s']:.1f}s "
            f"flops/chip={r['hlo_flops_per_chip']:.3e} "
            f"compute={r['compute_s']:.2e}s memory={r['memory_s']:.2e}s "
            f"collective={r['collective_s']:.2e}s "
            f"-> {r['bottleneck']} useful={r['useful_flops_ratio']:.2f} "
            f"peak={counts['peak_bytes'] / 1e9:.1f}GB", flush=True
        )
    return record


def table(records: list) -> str:
    """``records`` as a markdown table, one row a record: its mesh, dot
    and model TFLOP a chip, the useful ratio, the three roofline terms, the
    argument GB a chip and the traced peak GB a chip."""
    lines = ["| arch | shape | mesh | dot TFLOP | model TFLOP | useful "
             "| compute s | memory s | collective s | bottleneck "
             "| argument GB | traced peak GB |",
             "| --- " * 12 + "|"]

    def num(x: float) -> str:
        return f"{x:,.0f}" if x >= 1000 else f"{x:.4g}"

    for r in records:
        t = r["roofline"]
        cells = [r["arch"], r["shape"], r["mesh"],
                 num(t["hlo_flops_per_chip"] / 1e12),
                 num(t["model_flops_per_chip"] / 1e12),
                 f"{t['useful_flops_ratio']:.3f}", num(t["compute_s"]),
                 num(t["memory_s"]), num(t["collective_s"]), t["bottleneck"],
                 num(r["memory"]["argument_size_in_bytes"] / 1e9),
                 num(r["memory"]["peak_size_in_bytes"] / 1e9)]
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    where = ap.add_mutually_exclusive_group()
    where.add_argument("--multi-pod", action="store_true",
                       help="the 2x16x16 mesh (default: 16x16)")
    where.add_argument("--single-card", action="store_true",
                       help="one H100, no mesh")
    ap.add_argument("--all", action="store_true",
                    help="every arch but waste-pipeline x every shape, then "
                         "their records as a markdown table")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    kw = {"multi_pod": args.multi_pod,
          "mesh": SINGLE_CARD if args.single_card else None}

    if args.all:
        t0 = time.time()
        failures, records = [], []
        for arch in DRY_ARCHS:
            for shape in ALL_SHAPES:
                try:
                    records.append(dry_run_one(arch, shape.name,
                                               out_dir=args.out, **kw))
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
    rec = dry_run_one(args.arch, args.shape, out_dir=args.out, **kw)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
