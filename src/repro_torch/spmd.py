"""The model on a mesh: what the layers need when their tensors are
DTensors (``launch/sharding.py`` places them).

Most ops need nothing: DTensor propagates a sharding through them, as
GSPMD does in the reference, and inserts the collectives. Three kinds of
code go through ``torch.distributed.tensor.experimental.local_map``
instead, each where it is called, with its reason there:

- code that reads raw pointers: every CUDA kernel (a DTensor never
  reaches one), and the plain versions beside them, so that both routes
  place the same;
- ops whose work is local to a shard but which DTensor cannot propagate
  (a lookup into a vocabulary-sharded table, the MoE's dispatch, a write
  at a per-row position into a sharded cache);
- attention, whose kv heads a rank needs depend on its q heads.

``local`` is that call: each input is redistributed to the placements the
function needs, the function runs on the local shards, and the outputs are
wrapped with theirs. An input that stays replicated on a mesh dim over
which the output differs gets a partial gradient there: each rank's
gradient then holds only its own share.

``like`` makes a plain tensor made in the model (a mask, positions, a
zero) a replicated DTensor where it meets one.

``distribute`` and its kin place tensors on a mesh by a spec (a tuple
with one entry a dim, as ``launch/sharding.py``'s rules give it): each
rank keeps its shard of the tensor it was given, and nothing is sent
between ranks. ``place`` sets a model's parameters one at a time, so that
a rank holds its shards and one whole leaf at most, never the whole
model.
"""

from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch import nn
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def placements(spec: tuple, mesh) -> tuple:
    """One placement a mesh dim: ``Shard(d)`` on every mesh dim that an
    entry of dim ``d`` names (a tuple of names major first, as DTensor
    orders the shards of one dim over several mesh dims), else
    ``Replicate()``. ``mesh``: a ``DeviceMesh``, or anything with the
    axis ``names``."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or mesh.names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            i = names.index(axis)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names the axis {axis!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def distribute(t: torch.Tensor, mesh, spec: tuple) -> DTensor:
    """``t`` as a DTensor on ``mesh`` placed by ``spec``: each rank keeps
    a copy of its shard of its own ``t`` (every rank holds the same
    tensor), with no communication."""
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def zeros(shape, mesh, spec: tuple, dtype, device) -> DTensor:
    """A DTensor of zeros of global ``shape`` on ``mesh`` placed by
    ``spec``, of which this rank allocates only its shard, on ``device``
    (``meta`` allocates nothing)."""
    pl = placements(spec, mesh)
    local_shape, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    return DTensor.from_local(
        torch.zeros(local_shape, dtype=dtype, device=device), mesh, pl,
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _set_param(model: nn.Module, name: str, value: torch.Tensor) -> None:
    *parents, leaf = name.split(".")
    owner = model.get_submodule(".".join(parents)) if parents else model
    old = owner._parameters[leaf]
    owner._parameters[leaf] = nn.Parameter(value,
                                           requires_grad=old.requires_grad)


def distribute_model(model: nn.Module, mesh, specs: dict) -> nn.Module:
    """Replace every parameter of ``model`` that is not a DTensor yet by
    its DTensor on ``mesh`` (``specs``: name -> spec), in place."""
    for name, p in list(model.named_parameters()):
        if not is_dtensor(p):
            _set_param(model, name, distribute(p.data, mesh, specs[name]))
    return model


def place(model: nn.Module, mesh, specs: dict, state: dict,
          device) -> nn.Module:
    """Set ``model``'s parameters (on ``meta``, say) from ``state`` (name
    -> whole tensor, on the host), one at a time: each is taken out of
    ``state``, moved to ``device`` in its parameter's dtype and cut to
    this rank's shard before the next is taken. In place; ``state`` ends
    empty."""
    dtypes = {k: p.dtype for k, p in model.named_parameters()}
    for name in list(state):
        t = state.pop(name).to(device=device, dtype=dtypes[name])
        _set_param(model, name, distribute(t, mesh, specs[name]))
        del t
    return model


def distribute_tree(tensors: dict, mesh, specs: dict) -> dict:
    """A batch or a decode state (name -> tensor) on ``mesh``."""
    return {k: distribute(v, mesh, specs[k]) for k, v in tensors.items()}


def like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t``, a plain tensor that every rank holds alike (a mask,
    positions, a zero), as a replicated DTensor on ``ref``'s mesh when
    ``ref`` is a DTensor; else ``t``. (DTensor refuses to mix the two, and
    ``implicit_replication`` is a thread-local flag that the backward,
    which runs in autograd's threads, does not see.)"""
    if is_dtensor(ref) and not is_dtensor(t):
        mesh = ref.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return t


def settle(t):
    """``t`` with every partial placement reduced (all-reduced); a plain
    tensor as it is. The layers settle each block's output before its
    residual add, as Megatron and GSPMD do: left partial, DTensor would
    reduce-scatter it on the sequence at the next norm and then gather
    the next block's weights instead of its activations."""
    if is_dtensor(t) and any(p.is_partial() for p in t.placements):
        return t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return t


class _SettleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return settle(g)


def settle_grad(t):
    """``t`` unchanged, its gradient settled (all-reduced) in the backward:
    Megatron's ``f`` at the input of a block's column-parallel products.
    Left partial, DTensor carries the residual stream's gradient lazily and
    then gathers the next weight gradient's other operand instead."""
    return _SettleGrad.apply(t) if is_dtensor(t) else t


def unshard(t, dim: int):
    """DTensor ``t`` gathered on ``dim`` (settled first); a plain tensor as
    it is."""
    if not is_dtensor(t):
        return t
    t = settle(t)
    if Shard(dim) not in t.placements:
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if p == Shard(dim) else p for p in t.placements])


def placed_as(t, ref):
    """DTensor ``t`` redistributed to ``ref``'s placements; a plain tensor
    as it is."""
    if is_dtensor(t) and is_dtensor(ref) and t.placements != ref.placements:
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def follow(ref: tuple, dims: dict) -> tuple:
    """Placements for a tensor whose dims match ``ref``'s by ``dims``
    (ref dim -> this tensor's dim): ``Shard`` where ``ref`` is sharded on
    a dim that maps, ``Replicate`` elsewhere."""
    return tuple(Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                 else Replicate() for p in ref)


def offset(t: DTensor, dim: int) -> int:
    """The global index of the first element of ``dim`` that this rank's
    shard of ``t`` holds."""
    _, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return int(off[dim])


def coordinate(mesh, mesh_dim: int) -> int:
    """This rank's index along mesh dim ``mesh_dim``."""
    return mesh.get_coordinate()[mesh_dim]


def local(fn, mesh, args: tuple, in_placements: tuple, out_placements):
    """``fn(*local shards of args)`` through ``local_map``: a DTensor
    argument is redistributed to its entry of ``in_placements`` (None for
    a non-tensor argument), and the outputs are DTensors placed by
    ``out_placements`` (one tuple, or one a flattened output)."""
    single = isinstance(out_placements[0], (Shard, Replicate, Partial))
    first = out_placements if single else out_placements[0]
    # local_map reads a tuple as one placement list an output
    out_placements = list(out_placements) if single else \
        tuple(list(p) for p in out_placements)
    grads = tuple(
        None if pl is None else tuple(
            Partial() if p == Replicate() and o != Replicate() else p
            for p, o in zip(pl, first))
        for pl in in_placements)
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def attend(core, q, k, v, *extra, q_heads: int, kv_heads: int,
           q_seq: int | None = None):
    """Attention of DTensors through ``local``: ``core(q, k, v, *extra,
    q_offset)`` on the local shards, ``q_offset`` the global position of
    the first local query. q's sharded dims may be its batch (dim 0), its
    heads (``q_heads``) and its sequence (``q_seq``);
    k and v (heads at ``kv_heads``) follow q's batch, and its heads where
    theirs are sharded alike, else stay replicated and each rank slices
    the kv heads its q heads read (local because a q head ``h`` reads kv
    head ``h // (H / K)``). ``extra`` tensors have a batch dim 0 only.
    Returns a DTensor placed as q."""
    mesh = q.device_mesh
    q, k, v = settle(q), settle(k), settle(v)
    if any(p.is_shard() and p.dim not in (0, q_heads, q_seq)
           for p in q.placements):
        raise NotImplementedError(f"attention with q placed {q.placements}")
    kv_pl = tuple(Shard(0) if pq == Shard(0) else
                  Shard(kv_heads) if pq == Shard(q_heads)
                  and pk == Shard(kv_heads) else Replicate()
                  for pq, pk in zip(q.placements, k.placements))
    H, K = q.shape[q_heads], k.shape[kv_heads]
    G = H // K
    q_shape, q_off = compute_local_shape_and_global_offset(
        q.shape, mesh, q.placements)
    _, k_off = compute_local_shape_and_global_offset(k.shape, mesh, kv_pl)
    h0, n_h = q_off[q_heads], q_shape[q_heads]
    lo = h0 // G - k_off[kv_heads]
    n_kv = (h0 + n_h - 1) // G + 1 - h0 // G
    if n_h % n_kv or (n_kv > 1 and n_h // n_kv != G):
        raise NotImplementedError(f"{n_h} local q heads from head {h0} do "
                                  f"not read whole groups of {G}")
    s0 = 0 if q_seq is None else q_off[q_seq]
    ex_pl = tuple(follow(q.placements, {0: 0}) for _ in extra)

    def fn(ql, kl, vl, *ex):
        kl = kl.narrow(kv_heads, lo, n_kv)
        vl = vl.narrow(kv_heads, lo, n_kv)
        return core(ql, kl, vl, *ex, s0)

    out = local(fn, mesh, (q, k, v, *extra),
                (q.placements, kv_pl, kv_pl, *ex_pl), q.placements)
    if out.shape != q.shape:
        # local_map takes the shares for even: a sequence that the mesh
        # dim does not divide gets its global shape back
        out = DTensor.from_local(out.to_local(), mesh, out.placements,
                                 shape=q.shape,
                                 stride=torch.empty(q.shape,
                                                    device="meta").stride())
    return out


def scan(fn, x, *others, maps: tuple, channel: int):
    """A scan of DTensors through ``local``: ``fn(x, *others)`` on the
    local shards, each rank scanning its batch rows (dim 0) and channels
    (``channel``: d_inner, or heads) of ``x`` over the whole sequence.
    ``maps[i]`` maps x's dims to ``others[i]``'s. Returns a DTensor placed
    as x."""
    x = settle(x)
    if any(p.is_shard() and p.dim not in (0, channel) for p in x.placements):
        raise NotImplementedError(f"a scan of x placed {x.placements}: only "
                                  f"batch rows and channels are local")
    return local(fn, x.device_mesh, (x, *others),
                 (x.placements, *(follow(x.placements, m) for m in maps)),
                 x.placements)


def gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The local tensors ``t`` of the ranks of ``group`` concatenated on
    ``dim`` in rank order (an all-gather), inside a ``local`` function."""
    rows = t.movedim(dim, 0).contiguous()
    out = torch.ops._c10d_functional.all_gather_into_tensor(
        rows, group.size(), group.group_name)
    return funcol.wait_tensor(out).movedim(0, dim)


def halves(t):
    """``t.chunk(2, dim=-1)``. A DTensor column-sharded on its last dim
    over one mesh dim of size m goes through ``local``: rank r holds
    column blocks 2r and 2r + 1 of the 2m blocks of [x | z] and needs
    block r of x and of z, so each rank sends its two blocks to ranks
    2r and 2r + 1 (mod m) in one all-to-all, as GSPMD swaps them (a
    collective-permute), instead of DTensor's gather of the whole tensor
    to split it."""
    if not is_dtensor(t):
        return t.chunk(2, dim=-1)
    t = settle(t)
    mesh, last = t.device_mesh, t.ndim - 1
    dims = [i for i, p in enumerate(t.placements) if p == Shard(last)]
    if len(dims) > 1:
        return t.chunk(2, dim=-1)
    m = mesh.size(dims[0]) if dims else 1
    if m == 1:
        return local(lambda loc: loc.chunk(2, dim=-1), mesh, (t,),
                     (t.placements,), (t.placements, t.placements))
    i = dims[0]
    if m % 2 or (t.shape[-1] // 2) % m:
        return t.chunk(2, dim=-1)
    r = coordinate(mesh, i)
    group = mesh.get_group(i)
    src_x, src_z = r // 2, (m + r) // 2

    def fn(loc):
        half = loc.shape[-1] // 2
        send = [0] * m
        for j in (0, 1):
            send[(2 * r + j) % m] += half
        recv = [0] * m
        recv[src_x] += half
        recv[src_z] += half
        rows = loc.movedim(-1, 0).contiguous()
        got = funcol.all_to_all_single(rows, recv, send, group)
        x, z = funcol.wait_tensor(got).split(half, dim=0)
        return x.movedim(0, -1), z.movedim(0, -1)

    return local(fn, mesh, (t,), (t.placements,),
                 (t.placements, t.placements))
