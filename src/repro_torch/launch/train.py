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
gradients dropped. One card has no production mesh: ``mesh_kind`` takes
``"host"`` only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import save
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


def train_step(model: Model, opt_cfg: AdamWConfig, opt, batch: dict):
    """One eager step: ``model.loss(batch)``, its backward, the AdamW
    update of every parameter in place, the gradients dropped. Returns
    (loss, grad norm), 0-d tensors on the device."""
    loss = model.loss(batch)
    loss.backward()
    info = adamw_update(opt_cfg, None, opt, model)
    model.zero_grad(set_to_none=True)
    return loss.detach(), info["grad_norm"]


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
) -> list[dict]:
    """Train ``arch`` (``config`` when given, as it is) for ``steps`` steps
    of ``batch`` x ``seq`` tokens; returns the history records (``step``,
    ``loss``, ``grad_norm``, ``elapsed_s``) of every ``log_every``-th step
    and the last, and saves the weights to ``checkpoint_dir`` if given.
    ``device`` None -> CUDA; ``backend`` is the model's kernel backend."""
    if mesh_kind != "host":
        raise ValueError(f"mesh_kind {mesh_kind!r}: one card has no "
                         f"production mesh; use 'host'")
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
    device = resolve_device(device)
    model = Model(cfg, seed=seed, device=device, backend=backend,
                  init_device=device)
    model.requires_grad_(True)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(steps // 20, 5))
    corpus = SyntheticCorpus(cfg, seq, batch, seed=seed)
    opt = adamw_init(model)

    history = []
    t0 = time.time()
    for step in range(steps):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in corpus.batch(step).items()}
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
    args = ap.parse_args()
    hist = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        use_reduced=args.reduced, lr=args.lr, seed=args.seed,
        checkpoint_dir=args.checkpoint, width_mult=args.width_mult,
        device=args.device,
    )
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
