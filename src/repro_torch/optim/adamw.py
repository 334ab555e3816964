"""AdamW + cosine schedule + global-norm clipping in PyTorch: the port of
``repro/optim/adamw.py``.

Optimizer moments are kept in f32 whatever the parameter dtype, and the
arithmetic is the reference's, line for line, with its casts: the update
is computed in f32 from the clipped gradient, bias-corrected as
``mhat / (sqrt(vhat) + eps)``, decayed with ``weight_decay * p`` inside
the same step, and a bf16 parameter is rounded once, from
``p.f32 - lr * delta``, with no f32 master copy. ``torch.optim.AdamW``
rounds otherwise and has neither the schedule nor the clip.

The reference is functional so that its step can be jitted; here the
update is eager and in place. ``params`` is a ``Model`` (its named
parameters) or a dict of name -> tensor; gradients default to each
parameter's ``.grad``. A parameter with no gradient (one the loss never
reads, such as a Mamba-2 block's ``D``) counts as a zero gradient, as
``jax.grad`` gives zeros there: it is still decayed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch import spmd


class OptState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: dict                # name -> f32 tensor
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


def cosine_schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int tensor), as an f32 tensor:
    linear warmup, then a cosine down to ``min_lr_frac`` of ``lr``."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """The f32 L2 norm of every tensor of ``tree`` (a dict or an
    iterable), summed leaf after leaf in order."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves))


def adamw_init(params) -> OptState:
    """Zeroed f32 moments for every parameter, on its device; step 0."""
    params = _named(params)
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    device = next(iter(params.values())).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=zeros, nu={k: torch.zeros_like(v)
                                  for k, v in zeros.items()})


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt: OptState, params) -> dict:
    """One AdamW step, in place: ``params``, ``opt.step``, ``opt.mu`` and
    ``opt.nu`` are updated. ``grads`` is a dict of name -> gradient, or
    None to read each parameter's ``.grad``; a missing gradient is zeros.
    Returns ``{"lr", "grad_norm"}``, 0-d f32 tensors on the device."""
    params = _named(params)
    if grads is None:
        grads = {k: p.grad for k, p in params.items()}
    grads = {k: torch.zeros_like(p) if grads.get(k) is None else grads[k]
             for k, p in params.items()}
    # on a mesh, each gradient is reduced once, onto its moments' shards
    # (an all-reduce over the batch, or ZeRO-1's reduce-scatter)
    grads = {k: spmd.placed_as(g, opt.mu[k]) for k, g in grads.items()}
    gnorm = global_norm(grads)
    # a 0-d tensor numerator: a Python scalar over a tensor is computed
    # as the scalar times a reciprocal in torch, not a true division
    clip = spmd.like(torch.full((), cfg.clip_norm, dtype=torch.float32,
                                device=gnorm.device), gnorm)
    scale = torch.clamp_max(clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    opt.step.add_(1)
    lr = cosine_schedule(cfg, opt.step)
    step = opt.step.float()
    b1c = 1 - torch.pow(torch.full_like(step, cfg.b1), step)
    b2c = 1 - torch.pow(torch.full_like(step, cfg.b2), step)

    for k, p in params.items():
        g = grads[k].float() * scale
        m = cfg.b1 * opt.mu[k] + (1 - cfg.b1) * g
        v = cfg.b2 * opt.nu[k] + (1 - cfg.b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        opt.mu[k], opt.nu[k] = m, v
    return {"lr": lr, "grad_norm": gnorm}
