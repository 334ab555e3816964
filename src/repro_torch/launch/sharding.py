"""Sharding rules as DTensor placements: the port of
``repro/launch/sharding.py``.

The reference's scheme, rule for rule (megatron-style tensor parallelism
over ``model``, the batch over ``('pod', 'data')``):

- attention: wq/wk/wv column-parallel on the head axis, wo row-parallel;
  a head count that does not divide ``model`` leaves the weights
  replicated (``_fit`` takes the first candidate axis that divides);
- MLP: wg/wu column-parallel on d_ff, wd row-parallel;
- MoE: experts over ``model``; above 100 B parameters the per-expert FFN
  dim also over ``data`` (FSDP-flavoured);
- SSM: everything column-parallel on d_inner;
- caches: the batch over the data axes, kv heads over ``model`` or else
  the cache's sequence axis; a batch that does not divide (``long_500k``)
  shards the sequence instead.

Every function gives, per leaf, a spec: a tuple with one entry a dim, each
an axis name, a tuple of names or None, the entries of the reference's
``PartitionSpec``. Parameters and moments are keyed by the port's names
(``layers.3.attn.wq``); the reference stacks a layer stack's leaves on
leading axes (``stack/attn/wq`` [L, D, H, hd]), and its rules match the
trailing dims right-aligned, so each rule is evaluated on the stacked
shape (``carry.py`` maps the names) and the stacked dims are dropped (no
rule shards a layer axis at any arch of the pool; ``_unstack``). The
decode state and the batch have the reference's keys and shapes.

``placements`` (``spmd.placements``) turns a spec into DTensor placements
on a mesh: a tensor dim over ``('pod', 'data')`` is ``Shard(d)`` on both
mesh dims, the major one first, which is the order DTensor shards in;
``spmd.distribute`` and its kin place tensors by their specs. The rules
read only a mesh's axis names and sizes, so they take a
``mesh.AbstractMesh`` as well as a ``DeviceMesh``.
"""

from __future__ import annotations

import math

from repro_torch.carry import _stack_names
from repro_torch.launch.mesh import axis_names, axis_size, data_axes
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.spmd import placements  # noqa: F401  (the specs' placements)

MODEL, DATA = "model", "data"


def _one(axes):
    """A tuple of one axis name as the name, as ``PartitionSpec`` writes
    it."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(_axis_size(mesh, a) for a in axis)
    return axis_size(mesh, axis)


def _fit(mesh, dim: int, *candidates):
    """First candidate axis that exists in the mesh and divides dim."""
    for c in candidates:
        if c is None:
            return None
        sz = _axis_size(mesh, c)
        if sz > 1 and dim % sz == 0:
            return c
    return None


def _rule(mesh, name: str, shape: tuple, fsdp: bool, in_moe: bool = False):
    """Right-aligned spec entries for the *trailing* dims of a parameter
    (its stacked shape)."""
    d, n = shape, len(shape)
    M, D_ = MODEL, DATA

    def last(k):
        return d[n - k:]

    if name == "embed":
        V, _ = last(2)
        return [_fit(mesh, V, M), None]
    if name == "unembed":
        _, V = last(2)
        return [None, _fit(mesh, V, M)]
    if name in ("wq", "wk", "wv"):
        _, H, _ = last(3)
        return [None, _fit(mesh, H, M), None]
    if name in ("bq", "bk", "bv"):
        H, _ = last(2)
        return [_fit(mesh, H, M), None]
    if name == "wo":
        H, _, _ = last(3)
        return [_fit(mesh, H, M), None, None]
    if name == "wq_a":
        return [None, _fit(mesh, last(1)[0], M)]
    if name in ("wq_b", "wkv_b"):
        _, H, _ = last(3)
        return [None, _fit(mesh, H, M), None]
    if name == "wkv_a":
        return [None, None]
    if name in ("wg", "wu"):
        if in_moe and n >= 3:
            E, _, F = last(3)
            return [_fit(mesh, E, M), None, _fit(mesh, F, D_) if fsdp
                    else None]
        _, F = last(2)
        return [None, _fit(mesh, F, M)]
    if name == "wd":
        if in_moe and n >= 3:
            E, F, _ = last(3)
            return [_fit(mesh, E, M), _fit(mesh, F, D_) if fsdp else None,
                    None]
        F, _ = last(2)
        return [_fit(mesh, F, M), None]
    if name == "router":
        return [None, None]
    if name == "in_proj":
        _, E2 = last(2)
        return [None, _fit(mesh, E2, M)]
    if name == "conv_w":
        _, di = last(2)
        return [None, _fit(mesh, di, M)]
    if name in ("conv_b", "dt_bias", "D", "D_head", "norm_scale"):
        (c,) = last(1)
        return [_fit(mesh, c, M)]
    if name in ("x_dbc", "x_bcdt", "A_log"):
        if n >= 2:
            a, _ = last(2)
            return [_fit(mesh, a, M), None]
        return [_fit(mesh, last(1)[0], M)]
    if name == "dt_proj":
        _, di = last(2)
        return [None, _fit(mesh, di, M)]
    if name == "out_proj":
        di, _ = last(2)
        return [_fit(mesh, di, M), None]
    # norms & anything small: replicate
    return [None] * min(n, 1)


def stack_dims(cfg: ModelConfig, name: str) -> tuple:
    """The layer axes the reference stacks the port's parameter ``name``
    on: (L,) for ``layers.3.attn.wq``, (n_groups, g) for a hybrid group's
    block, () for ``embed`` or the hybrid's ``shared_attn``."""
    head = name.split(".")[0]
    for _, port, layers in _stack_names(cfg):
        if port == head:
            return tuple(layers)
    return ()


def _keys(name: str) -> list:
    return name.split(".")


def _unstack(cfg, name, shape, spec) -> tuple:
    """``spec`` of the stacked leaf, less its layer axes. A layer axis
    that the spec shards (the right-aligned ``A_log`` rule meets a hybrid
    group's [n_groups, g, H] on g where ``model`` divides g, as at
    ``reduced`` sizes, never at the pool's) has no tensor of the port to
    shard: each layer's tensor is replicated there, as GSPMD gathers the
    leaf for the scan's dynamic slice of it."""
    del shape
    return tuple(spec[len(stack_dims(cfg, name)):])


def param_specs(mesh, cfg: ModelConfig, shapes: dict, phase: str = "train",
                strategy: str = "tp") -> dict:
    """Name -> spec of every parameter (``shapes``: name -> shape, as
    ``{k: p.shape for k, p in model.named_parameters()}``).

    strategy "tp": megatron tensor/expert parallelism over ``model``;
    "dp_zero1": every parameter replicated (pair with ``moment_specs``).
    ``phase`` is the reference's argument; no rule reads it."""
    del phase
    if strategy == "dp_zero1":
        return {k: (None,) * len(s) for k, s in shapes.items()}
    fsdp = cfg.param_count() > 100e9
    out = {}
    for k, s in shapes.items():
        stacked = stack_dims(cfg, k) + tuple(s)
        keys = _keys(k)
        short = next(x for x in reversed(keys) if not x.isdigit())
        in_moe = "moe" in keys and "shared" not in keys
        trailing = _rule(mesh, short, stacked, fsdp, in_moe)
        spec = [None] * (len(stacked) - len(trailing)) + list(trailing)
        out[k] = _unstack(cfg, k, stacked, spec)
    return out


def moment_specs(mesh, cfg: ModelConfig, shapes: dict, strategy: str,
                 tp_specs: dict) -> dict:
    """Optimizer-moment specs: the parameters' for "tp"; for "dp_zero1"
    each f32 moment shards its first dim (of the stacked leaf) that every
    axis divides across all axes, else its first dim ``model`` divides
    (ZeRO-1)."""
    if strategy != "dp_zero1":
        return dict(tp_specs)
    axes = _one(axis_names(mesh))
    total = _axis_size(mesh, axes)
    out = {}
    for k, s in shapes.items():
        stacked = stack_dims(cfg, k) + tuple(s)
        spec = [None] * len(stacked)
        for i, dim in enumerate(stacked):
            if dim % total == 0:
                spec[i] = axes
                break
        else:
            for i, dim in enumerate(stacked):
                if dim % _axis_size(mesh, MODEL) == 0 and dim > 1:
                    spec[i] = MODEL
                    break
        out[k] = _unstack(cfg, k, stacked, spec)
    return out


def pick_strategy(cfg: ModelConfig, shape_kind: str) -> str:
    """Small dense models train pure data-parallel; everything else uses
    tensor/expert parallelism."""
    if shape_kind == "train" and cfg.param_count() <= 4e9 \
            and not cfg.uses_moe:
        return "dp_zero1"
    return "tp"


def batch_specs(mesh, cfg: ModelConfig, shape: InputShape, specs: dict,
                strategy: str = "tp") -> dict:
    """Input specs: the batch over the data axes (all axes for
    "dp_zero1"), replicated when the batch does not divide. ``specs``:
    name -> tensor or shape."""
    daxes = _one(axis_names(mesh) if strategy == "dp_zero1"
                 else data_axes(mesh))
    dsz = _axis_size(mesh, daxes)
    out = {}
    for k, v in specs.items():
        dims = list(getattr(v, "shape", v))
        spec = [None] * len(dims)
        if dims and dims[0] % dsz == 0 and dsz > 1:
            spec[0] = daxes
        out[k] = tuple(spec)
    return out


def decode_state_specs(mesh, cfg: ModelConfig, shape: InputShape,
                       state_shapes: dict) -> dict:
    """KV-cache / SSM-state specs of a decode state (name -> tensor or
    shape): a divisible batch over the data axes with heads (or head_dim)
    over ``model``; batch 1 (``long_500k``) shards the cache's sequence
    axis instead."""
    daxes = _one(data_axes(mesh))
    dsz = _axis_size(mesh, daxes)
    B = shape.global_batch
    batch_ok = B % dsz == 0 and dsz > 1
    out = {}
    for short, v in state_shapes.items():
        dims = tuple(getattr(v, "shape", v))
        spec: list = [None] * len(dims)
        out[short] = spec
        if short == "pos":
            continue
        b_idx = next((i for i, s in enumerate(dims) if s == B), None)
        if short in ("k", "v"):
            s_idx, k_idx = len(dims) - 3, len(dims) - 2
            ax = _fit(mesh, dims[k_idx], MODEL)
            if ax:
                spec[k_idx] = ax
            if batch_ok and b_idx is not None:
                spec[b_idx] = daxes
                if not ax:
                    spec[s_idx] = _fit(mesh, dims[s_idx], MODEL)
            else:
                seq_axes = daxes if ax else (*_tuple(daxes), MODEL)
                spec[s_idx] = _fit(mesh, dims[s_idx], seq_axes, daxes)
        elif short == "ckv":
            s_idx = len(dims) - 2
            if batch_ok and b_idx is not None:
                spec[b_idx] = daxes
            elif dims[s_idx] % dsz == 0 and dsz > 1:
                spec[s_idx] = daxes
        elif short in ("h", "h_tail"):
            if batch_ok and b_idx is not None:
                spec[b_idx] = daxes
            tgt = len(dims) - 2 if cfg.mamba_version == 1 else len(dims) - 3
            spec[tgt] = _fit(mesh, dims[tgt], MODEL)
        elif short in ("conv", "conv_tail"):
            if batch_ok and b_idx is not None:
                spec[b_idx] = daxes
            spec[len(dims) - 1] = _fit(mesh, dims[-1], MODEL)
        elif short == "memory":
            if batch_ok and b_idx is not None:
                spec[b_idx] = daxes
    return {k: tuple(v) for k, v in out.items()}


def _tuple(axes) -> tuple:
    return axes if isinstance(axes, tuple) else (axes,)


def replicated(ndim: int = 0) -> tuple:
    return (None,) * ndim


# ---------------------------------------------------------------------------
# The two activation hints
# ---------------------------------------------------------------------------

def configure_moe_sharding(mesh, cfg: ModelConfig) -> None:
    """GShard-style local dispatch groups: one group a data shard, and the
    grouped tokens [G, Tg, D] placed ``Shard(0)`` over the data axes, so
    each group's routing and scatter are local. Capacity is per group, so
    this changes the function, as in the reference."""
    from repro_torch.models.moe import set_dispatch_groups, \
        set_dispatch_sharding

    daxes = data_axes(mesh)
    dsz = _axis_size(mesh, daxes)
    if not cfg.uses_moe or dsz <= 1:
        set_dispatch_groups(1)
        set_dispatch_sharding(None)
        return
    set_dispatch_groups(dsz)
    set_dispatch_sharding(daxes)


def configure_attention_sharding(mesh, cfg: ModelConfig, phase: str) -> None:
    """Heads that divide ``model`` shard attention by heads (propagated
    from the column-parallel wq, no hint); otherwise, in train and
    prefill, q is sequence-sharded over ``model``."""
    from repro_torch.models.layers import set_attention_q_sharding

    msz = _axis_size(mesh, MODEL)
    heads_ok = cfg.n_heads > 0 and cfg.n_heads % max(msz, 1) == 0
    if phase == "decode" or heads_ok or cfg.arch_type == "ssm" or msz <= 1:
        set_attention_q_sharding(None)
        return
    set_attention_q_sharding(MODEL)
