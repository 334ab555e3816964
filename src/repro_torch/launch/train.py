"""The trainer in PyTorch: the port of ``repro/launch/train.py``.

Trains any arch of the pool for a few steps on the synthetic corpus, on
one card (or the CPU), with the reference's loss (``Model.loss``, remat
on), AdamW and cosine schedule, history records and ``[train …]`` lines:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --reduced --steps 200 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --full --steps 5 --batch 1 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --device cpu --steps 20

Runs on CUDA unless ``device`` (``--device``) names another device; on the
card the weights are drawn there. A step is eager: the loss, its backward
(through the kernels' autograd functions: forward on the kernel, backward
on the recomputed plain version), the AdamW update in place, and the
gradients dropped.

``mesh_kind="prod"`` runs the same step on the production mesh
(``launch/mesh.py``: 16 x 16, or 2 x 16 x 16 with ``multi_pod``), one rank
a card, the process group from the launcher's environment:

    torchrun --nnodes 32 --nproc-per-node 8 ... \
        -m repro_torch.launch.train --arch granite-8b --full --mesh prod

Every rank draws the same weights from the seed, one at a time, and keeps
its shard of each as it is drawn (``setup_on_mesh``); the parameters,
AdamW moments (made as sharded zeros) and batches are DTensors placed per
``launch/sharding.py`` (``pick_strategy``, both activation hints). It
raises, before touching any process group, unless the world size is 256
(512 with ``multi_pod``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch import spmd
from repro_torch._device import resolve_device
from repro_torch.checkpoint import save
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import InputShape
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
)


def train_step(model: Model, opt_cfg: AdamWConfig, opt, batch: dict):
    """One eager step: ``model.loss(batch)``, its backward, the AdamW
    update of every parameter in place, the gradients dropped. Returns
    (loss, grad norm), 0-d tensors on the device."""
    loss = model.loss(batch)
    loss.backward()
    info = adamw_update(opt_cfg, None, opt, model)
    model.zero_grad(set_to_none=True)
    return loss.detach(), info["grad_norm"]


def _production_mesh(multi_pod: bool):
    """The production mesh over the launcher's process group (NCCL on
    cards, gloo without CUDA), each rank on its card; raises, naming the
    sizes, on any world size but 256 (512 multi-pod), before any group is
    set up."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    need = 512 if multi_pod else 256
    if not dist.is_initialized() and world != need:
        raise ValueError(f"mesh_kind 'prod' needs a world size of {need} "
                         f"({'2x16x16' if multi_pod else '16x16'}); this "
                         f"launch has {world}")
    if not dist.is_initialized():
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if cuda else "gloo")
    return make_production_mesh(multi_pod=multi_pod)


def place_on_mesh(mesh, cfg, model: Model):
    """Place ``model`` on ``mesh`` per ``pick_strategy``, with both
    activation hints set: its parameters that are not DTensors yet are
    distributed in place. Returns the AdamW state, its moments made as
    zeros placed by the moment specs (a rank allocates its shards only),
    and a function placing a batch."""
    strategy = sharding.pick_strategy(cfg, "train")
    sharding.configure_attention_sharding(mesh, cfg, "train")
    sharding.configure_moe_sharding(mesh, cfg)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    p_specs = sharding.param_specs(mesh, cfg, shapes, "train", strategy)
    m_specs = sharding.moment_specs(mesh, cfg, shapes, strategy, p_specs)
    spmd.distribute_model(model, mesh, p_specs)
    device = model.embed.device
    moments = [{k: spmd.zeros(shape, mesh, m_specs[k], torch.float32,
                              device) for k, shape in shapes.items()}
               for _ in range(2)]
    opt = OptState(step=spmd.distribute(
        torch.zeros((), dtype=torch.int32, device=device), mesh, ()),
        mu=moments[0], nu=moments[1])

    def batch(b: dict) -> dict:
        shape = InputShape("train", b["tokens"].shape[1],
                           b["tokens"].shape[0], "train")
        return spmd.distribute_tree(b, mesh, sharding.batch_specs(
            mesh, cfg, shape, b, strategy=strategy))

    return opt, batch


def setup_on_mesh(mesh, cfg, *, seed: int = 0, device=None,
                  backend: str = "auto"):
    """What ``train(mesh_kind="prod")`` trains: the model drawn from
    ``seed`` on ``device`` with each weight cut to this rank's shard as it
    is drawn (``Model.on_mesh``; no rank ever holds the whole model), and
    ``place_on_mesh``'s AdamW state and batch placer. Returns (model,
    opt, place_batch)."""
    shapes = {k: tuple(p.shape) for k, p in
              Model(cfg, device="meta").named_parameters()}
    specs = sharding.param_specs(mesh, cfg, shapes, "train",
                                 sharding.pick_strategy(cfg, "train"))
    model = Model.on_mesh(cfg, mesh, specs, seed=seed, device=device,
                          backend=backend, init_device=device)
    model.requires_grad_(True)
    opt, place_batch = place_on_mesh(mesh, cfg, model)
    return model, opt, place_batch


def train(
    arch: str,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    use_reduced: bool = True,
    lr: float = 3e-4,
    seed: int = 0,
    mesh_kind: str = "host",
    log_every: int = 10,
    checkpoint_dir: str | None = None,
    width_mult: int = 1,
    config=None,
    device=None,
    backend: str = "auto",
    multi_pod: bool = False,
) -> list[dict]:
    """Train ``arch`` (``config`` when given, as it is) for ``steps`` steps
    of ``batch`` x ``seq`` tokens; returns the history records (``step``,
    ``loss``, ``grad_norm``, ``elapsed_s``) of every ``log_every``-th step
    and the last, and saves the weights to ``checkpoint_dir`` if given.
    ``device`` None -> CUDA; ``backend`` is the model's kernel backend;
    ``mesh_kind`` "host" (one device) or "prod" (the production mesh,
    ``multi_pod`` its 2 x 16 x 16 form)."""
    if mesh_kind not in ("host", "prod"):
        raise ValueError(f"mesh_kind {mesh_kind!r}: 'host' or 'prod'")
    cfg = config if config is not None else get_config(arch)
    if config is not None:
        use_reduced = False
    if use_reduced:
        cfg = reduced(cfg)
        if width_mult > 1:
            cfg = dataclasses.replace(
                cfg,
                d_model=cfg.d_model * width_mult,
                d_ff=cfg.d_ff * width_mult if cfg.d_ff else 0,
                n_layers=cfg.n_layers * 2,
                vocab_size=cfg.vocab_size * 8,
            )
    mesh = _production_mesh(multi_pod) if mesh_kind == "prod" else None
    if mesh is not None and device is None:
        device = f"cuda:{torch.cuda.current_device()}"
    device = resolve_device(device)
    place_batch = None
    if mesh is not None:
        model, opt, place_batch = setup_on_mesh(mesh, cfg, seed=seed,
                                                device=device,
                                                backend=backend)
    else:
        model = Model(cfg, seed=seed, device=device, backend=backend,
                      init_device=device)
        model.requires_grad_(True)
        opt = adamw_init(model)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(steps // 20, 5))
    corpus = SyntheticCorpus(cfg, seq, batch, seed=seed)

    history = []
    t0 = time.time()
    for step in range(steps):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in corpus.batch(step).items()}
        if place_batch is not None:
            b = place_batch(b)
        loss, gnorm = train_step(model, opt_cfg, opt, b)
        if step % log_every == 0 or step == steps - 1:
            rec = {
                "step": step,
                "loss": float(loss),
                "grad_norm": float(gnorm),
                "elapsed_s": round(time.time() - t0, 1),
            }
            history.append(rec)
            print(f"[train {arch}] {json.dumps(rec)}")
    if checkpoint_dir:
        save(checkpoint_dir, model, step=steps,
             extra={"arch": arch, "reduced": use_reduced})
    return history


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--width-mult", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--mesh", default="host", choices=("host", "prod"))
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    hist = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        use_reduced=args.reduced, lr=args.lr, seed=args.seed,
        checkpoint_dir=args.checkpoint, width_mult=args.width_mult,
        device=args.device, mesh_kind=args.mesh, multi_pod=args.multi_pod,
    )
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
