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
outside any Pallas kernel.

On a mesh (DTensor weights, ``launch/sharding.py``) the grouped tokens
[G, Tg, D] are placed ``Shard(0)`` over the axes ``set_dispatch_sharding``
names (the reference's hint), and each rank dispatches its groups to its
experts through ``spmd.local``: it routes over all E experts, keeps the
slots of its own, and its output is a partial sum over the expert shards.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import spmd
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


#: The mesh axes that shard the grouped tokens' G on a mesh (None: G
#: follows the tokens' batch sharding).
_GROUP_AXES = None


def set_dispatch_sharding(axes) -> None:
    global _GROUP_AXES
    _GROUP_AXES = axes


def route(xf, router, top_k: int):
    """xf: [T,D] -> (probs [T,E] f32, gate [T,k], idx [T,k]): the router's
    softmax and its k largest entries a token, ties to the lower index."""
    logits = torch.einsum("td,de->te", xf.float(), router)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, gate[:, :top_k], idx[:, :top_k]


def _dispatch_one(xf, router, wg, wu, wd, top_k, cap, act, e0: int = 0):
    """Dispatch + expert FFN for ONE group. xf: [Tg, D]. ``wg``, ``wu``,
    ``wd`` may hold a slice of the experts, from expert ``e0`` (a rank's
    shard on a mesh): the slots routed elsewhere then give zeros."""
    Tg, D = xf.shape
    E = router.shape[-1]
    E_l = wg.shape[0]
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
    buf = buf[:E * cap].view(E, cap, D)[e0:e0 + E_l]
    g = act_fn(act)(torch.einsum("ecd,edf->ecf", buf, wg))
    u = torch.einsum("ecd,edf->ecf", buf, wu)
    out_buf = torch.einsum("ecf,efd->ecd", g * u, wd)          # [E_l,cap,D]
    if E_l < E:
        local_e = e_flat - e0
        keep = keep & (local_e >= 0) & (local_e < E_l)
        e_flat = local_e.clamp(0, E_l - 1)
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

    grouped = _grouped_on_mesh if spmd.is_dtensor(x) else _grouped
    y, aux = grouped(p, x.reshape(G, Tg, D), top_k, cap, act)
    y = y.reshape(B, S, D)
    if "shared" in p:
        y = y + mlp(p["shared"], x, act)
    return y, aux.mean()


def _grouped(p, xg, top_k, cap, act, e0: int = 0):
    """(y [G,Tg,D], aux [G]) of the groups of xg [G,Tg,D]."""
    ys, auxs = zip(*(
        _dispatch_one(xf, p["router"], p["wg"], p["wu"], p["wd"], top_k,
                      cap, act, e0)
        for xf in xg))
    return torch.stack(ys), torch.stack(auxs)


def _grouped_on_mesh(p, xg, top_k, cap, act):
    """``_grouped`` of DTensors. local_map: DTensor has no rule for the
    dispatch's sort, scatter and per-slot gather, and a rank's groups and
    experts are local to it. The groups go ``Shard(0)`` over the dispatch
    axes where their count divides them (else, as for the one group of a
    one-token batch, they stay placed as they are), the experts keep
    their shards over ``model`` (an FSDP shard of their FFN dim is
    gathered), and y comes out partial over the expert shards; aux, the
    same on every expert shard, is split evenly among them, so that its
    gradient is counted once."""
    mesh = xg.device_mesh
    names = mesh.mesh_dim_names
    xg = spmd.settle(xg)
    axes = _GROUP_AXES if _GROUP_AXES and xg.shape[0] % math.prod(
        mesh.size(names.index(a)) for a in _GROUP_AXES) == 0 else None
    x_pl = tuple(spmd.Shard(0) if axes and n in axes
                 else spmd.Replicate() if axes else pl
                 for n, pl in zip(names, xg.placements))
    w_pl = tuple(spmd.Shard(0) if pl == spmd.Shard(0) else spmd.Replicate()
                 for pl in p["wg"].placements)
    n_e = math.prod(n for n, pl in zip(mesh.shape, w_pl)
                    if pl == spmd.Shard(0))
    e0 = spmd.offset(p["wg"], 0)
    out_pl = tuple(spmd.Partial() if w == spmd.Shard(0) else x
                   for x, w in zip(x_pl, w_pl))

    def fn(xl, router, wg, wu, wd):
        y, aux = _grouped({"router": router, "wg": wg, "wu": wu, "wd": wd},
                          xl, top_k, cap, act, e0)
        return y, aux / n_e

    return spmd.local(fn, mesh, (xg, p["router"], p["wg"], p["wu"], p["wd"]),
                      (x_pl, tuple(spmd.Replicate() for _ in names),
                       w_pl, w_pl, w_pl), (out_pl, out_pl))


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
