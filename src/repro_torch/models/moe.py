"""Mixture-of-Experts layer with capacity-based token dispatch, in
PyTorch: the port of ``repro/models/moe.py``.

Expert weights live on a leading ``E`` axis; tokens are scattered into
per-expert buffers of static capacity ``cap = max(int(cf · Tg · k / E), 1)``
and gathered back with their router gates, so the expert products run over
``E × cap`` slots whatever the routing. Covers DeepSeek-V2 (shared + routed
experts, top-6 of 160), Kimi-K2 (top-8 of 384) and Moonlight (top-6 of 64),
plus a Switch-style auxiliary load-balance loss.

The routing follows ``jax.lax.top_k``: the k largest router probabilities,
ties broken by the lower expert index. ``torch.topk`` promises no order
among ties, so the top k are taken from a stable descending sort. The
order matters twice: the first choice feeds the aux loss's density, and
the flat (token, k) order sets each slot's position in its expert's buffer.

Plain torch on every device: the reference computes the MoE in jnp,
outside any Pallas kernel. The JAX package's ``set_dispatch_sharding``
hint is a GSPMD sharding constraint with no counterpart on one card, so it
is left out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import act_fn, init_mlp, mlp, normal_init


def init_moe(gen, d_model, n_experts, moe_d_ff, n_shared,
             dtype=torch.bfloat16, device=None) -> dict:
    """The router is f32 in every model dtype, as in the reference."""
    s = d_model ** -0.5

    def draw(shape, scale, dt=dtype):
        return normal_init(gen, shape, scale, dt, device)

    p = {
        "router": draw((d_model, n_experts), s, torch.float32),
        "wg": draw((n_experts, d_model, moe_d_ff), s),
        "wu": draw((n_experts, d_model, moe_d_ff), s),
        "wd": draw((n_experts, moe_d_ff, d_model), moe_d_ff ** -0.5),
    }
    if n_shared:
        p["shared"] = init_mlp(gen, d_model, moe_d_ff * n_shared, dtype,
                               device)
    return p


#: Number of dispatch groups (GShard-style "local groups"); capacity is per
#: group. 1 = single global group.
_DISPATCH_GROUPS = 1


def set_dispatch_groups(g: int) -> None:
    global _DISPATCH_GROUPS
    _DISPATCH_GROUPS = max(int(g), 1)


def route(xf, router, top_k: int):
    """xf: [T,D] -> (probs [T,E] f32, gate [T,k], idx [T,k]): the router's
    softmax and its k largest entries a token, ties to the lower index."""
    logits = torch.einsum("td,de->te", xf.float(), router)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, gate[:, :top_k], idx[:, :top_k]


def _dispatch_one(xf, router, wg, wu, wd, top_k, cap, act):
    """Dispatch + expert FFN for ONE group. xf: [Tg, D]."""
    Tg, D = xf.shape
    E = router.shape[-1]
    probs, gate, idx = route(xf, router, top_k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    density = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(density * probs.mean(dim=0))

    # each (token, k) slot's position in its expert's buffer: the number of
    # earlier slots, in flat (token, k) order, routed to the same expert.
    # The one-hot is expert-major ([E, Tg*k]), so the running count is a
    # scan along the inner dim: the reference's [Tg*k, E] layout makes CUDA
    # scan the outer dim, far slower (tools/time_moe_dispatch.py). The
    # counts are the same.
    e_flat = idx.reshape(-1)
    flat = (e_flat == torch.arange(E, device=xf.device)[:, None]).long()
    pos = (torch.cumsum(flat, dim=1) - flat).gather(0, e_flat[None, :])[0]
    keep = pos < cap
    pos = torch.where(keep, pos, 0)

    # The reference adds each kept slot's token into zeroed buffers, and a
    # zero at position 0 of its expert for a dropped slot. Every kept
    # (expert, position) is unique, so a copy gives the same buffers: kept
    # rows land once, dropped ones on a spare row past the buffers (one row
    # taking every drop would serialise an accumulating scatter), and
    # + 0.0 turns a -0.0 into the +0.0 that the reference's add gives.
    x_rep = torch.repeat_interleave(xf, top_k, dim=0)
    rows = torch.where(keep, e_flat * cap + pos, E * cap)
    buf = torch.zeros((E * cap + 1, D), dtype=xf.dtype, device=xf.device)
    buf[rows] = x_rep + 0.0
    buf = buf[:E * cap].view(E, cap, D)
    g = act_fn(act)(torch.einsum("ecd,edf->ecf", buf, wg))
    u = torch.einsum("ecd,edf->ecf", buf, wu)
    out_buf = torch.einsum("ecf,efd->ecd", g * u, wd)            # [E,cap,D]
    y_rep = out_buf[e_flat, pos] * keep[:, None].to(xf.dtype)
    y = (y_rep.reshape(Tg, top_k, D) * gate[..., None].to(xf.dtype)).sum(1)
    return y, aux


def moe_ffn(p, x, top_k: int, capacity_factor: float = 1.25, act="silu"):
    """x: [B,S,D] -> (y, aux_loss).

    GShard-style local groups: tokens reshaped to [G, Tg, D]
    (G = ``_DISPATCH_GROUPS`` where it divides the B·S tokens, else 1);
    routing, per-group capacity, positions and the scatter/gather are
    group-local, and the aux loss is the groups' mean."""
    B, S, D = x.shape
    E = p["router"].shape[-1]
    T = B * S
    G = _DISPATCH_GROUPS if T % _DISPATCH_GROUPS == 0 else 1
    Tg = T // G
    cap = max(int(capacity_factor * Tg * top_k / E), 1)

    ys, auxs = zip(*(
        _dispatch_one(xf, p["router"], p["wg"], p["wu"], p["wd"], top_k,
                      cap, act)
        for xf in x.reshape(G, Tg, D)))
    y = torch.stack(ys).reshape(B, S, D)
    if "shared" in p:
        y = y + mlp(p["shared"], x, act)
    return y, torch.stack(auxs).mean()


def _frozen(t) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class MoE(nn.Module):
    """``moe_ffn`` as a module, so that a forward hook sees each MoE
    layer's input. Parameters ``router``, ``wg``, ``wu``, ``wd`` and, with
    shared experts, ``shared.wg/wu/wd``: the names of ``init_moe``'s
    leaves."""

    def __init__(self, gen, d_model, n_experts, moe_d_ff, n_shared,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        p = init_moe(gen, d_model, n_experts, moe_d_ff, n_shared, dtype,
                     device)
        shared = p.pop("shared", None)
        for name, t in p.items():
            setattr(self, name, _frozen(t))
        self.shared = None if shared is None else nn.ParameterDict(
            {k: _frozen(v) for k, v in shared.items()})

    def forward(self, x, top_k: int, capacity_factor: float = 1.25,
                act="silu"):
        p = dict(self.named_parameters(recurse=False))
        if self.shared is not None:
            p["shared"] = self.shared
        return moe_ffn(p, x, top_k, capacity_factor, act)
