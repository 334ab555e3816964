"""Carry fleet state across from the JAX package, and back.

``fleet_from_numpy`` takes a ``repro`` ``FleetState`` whose leaves are numpy
arrays (or any object with the same field names, this package's
``FleetState`` included) and builds this package's state from copies of
them, so that both engines can start from the same mid-run state.
``fleet_to_numpy`` and ``stats_to_numpy`` go the other way.
``sched_state_from_numpy`` does the same for a single-controller
``SchedState`` (the state of ``hp_place`` and ``lp_place``).
``model_params_from_numpy`` takes a ``repro`` ``Model.init`` parameter tree
of numpy arrays and gives this package's ``Model`` state;
``model_params_to_numpy`` goes the other way (for weights, or gradients by
parameter name); ``decode_state_from_numpy`` does the same for a decode
state; ``opt_state_from_numpy`` and ``opt_state_to_numpy`` carry an AdamW
state across in both directions. This module imports neither package: it
reads fields and keys by name.

numpy has no bfloat16. A bf16 leaf comes out of this package as its raw
bits, numpy dtype ``BF16_BITS`` (``V2``): the bytes ``np.savez`` writes for
the reference's ``ml_dtypes.bfloat16`` arrays. Both such arrays and
``ml_dtypes`` ones carry in.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch._device import resolve_device
from repro_torch.core.tensor_state import SchedState
from repro_torch.fleet.metrics import _host
from repro_torch.fleet.metrics import stats_to_numpy  # noqa: F401 (re-export)
from repro_torch.fleet.state import FleetState
from repro_torch.optim.adamw import OptState

#: numpy's dtype of a bf16 leaf's raw bits (what ``np.savez`` stores)
BF16_BITS = np.dtype("V2")

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool}


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unexpected leaf dtype {a.dtype}")
    return torch.tensor(a, dtype=_DTYPES[a.dtype], device=device)


def sched_state_from_numpy(s, *, device=None) -> SchedState:
    """A copy of scheduler state ``s`` (unbatched or batched) on
    ``device`` (``None`` -> CUDA)."""
    device = resolve_device(device)
    return SchedState(*(
        _tensor(getattr(s, f), device) for f in SchedState._fields
    ))


def fleet_from_numpy(d, *, device=None) -> FleetState:
    """A copy of fleet state ``d`` on ``device`` (``None`` -> CUDA)."""
    device = resolve_device(device)
    return FleetState(sched_state_from_numpy(d.sched, device=device), *(
        _tensor(getattr(d, f), device) for f in FleetState._fields[1:]
    ))


def fleet_to_numpy(fs: FleetState) -> FleetState:
    """The same fields, as numpy arrays on the host."""
    return FleetState(SchedState(*map(_host, fs.sched)),
                      *map(_host, fs[1:]))


def _leaf_converter(cfg, device):
    """numpy leaf -> tensor on ``device``, keeping the leaf's own dtype: an
    f32 leaf stays f32 (the SSM's ``D``, ``dt_bias``, ``A_log`` and
    ``D_head`` and the MoE's ``router`` in a bf16 model), an int32 leaf
    stays int32, and any other float leaf goes to ``cfg.dtype``.

    ``jax.device_get`` gives bf16 leaves as ``ml_dtypes.bfloat16`` arrays,
    which ``torch.from_numpy`` refuses: they go through float32, which holds
    each bf16 value exactly. A ``BF16_BITS`` leaf is read as bf16 bits."""
    dtype = getattr(torch, cfg.dtype)

    def conv(x):
        a = np.asarray(x)
        if a.dtype == np.int32:
            return torch.from_numpy(np.array(a)).to(device)
        if a.dtype == BF16_BITS:
            return bf16_from_bits(a).to(device=device, dtype=dtype)
        to = torch.float32 if a.dtype == np.float32 else dtype
        a = np.ascontiguousarray(a.astype(np.float32))
        return torch.from_numpy(a).to(device=device, dtype=to)

    return conv


def _leaves(tree, prefix: str):
    """(dotted path, leaf) of every leaf of a nested dict."""
    for key, val in tree.items():
        path = f"{prefix}.{key}"
        if isinstance(val, dict):
            yield from _leaves(val, path)
        else:
            yield path, val


def bf16_from_bits(a: np.ndarray) -> torch.Tensor:
    """A ``BF16_BITS`` array as the bf16 tensor it holds, on the host."""
    bits = np.ascontiguousarray(a).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; a bf16 tensor as its ``BF16_BITS``. A
    DTensor is gathered whole first (a collective: every rank calls it)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16_BITS).copy()
    return t.numpy().copy()


def _stack_names(cfg) -> list:
    """(tree key, port name, stacked layer axes) of each layer stack of
    ``cfg``'s parameter tree: ``stack`` leaves ``[L, …]`` are the port's
    ``layers.<i>.…``, and so on (``model_params_from_numpy``)."""
    if cfg.arch_type == "ssm":
        return [("ssm_stack", "ssm_stack", (cfg.n_layers,))]
    if cfg.arch_type == "hybrid":
        g = cfg.shared_attn_every
        n_groups, rem = divmod(cfg.n_layers, g)
        return [("groups", "groups", (n_groups, g)),
                *([("tail", "tail", (rem,))] if rem else []),
                ("shared_attn", "shared_attn", ())]
    if cfg.is_encoder_decoder:
        return [("enc_stack", "enc_layers", (cfg.n_encoder_layers,)),
                ("dec_stack", "dec_layers", (cfg.n_layers,))]
    nd = cfg.first_dense_layers if cfg.uses_moe else 0
    return [*([("dense_stack", "dense_layers", (nd,))] if nd else []),
            ("stack", "layers", (cfg.n_layers - nd,))]


def _unstack_tree(cfg, params, conv) -> dict:
    """The port's flat names -> ``conv(leaf)`` of a reference tree."""
    state = {k: conv(params[k]) for k in ("embed", "ln_f", "unembed")
             if k in params}
    for key, name, layers in _stack_names(cfg):
        for path, leaf in _leaves(params[key], name):
            if np.shape(leaf)[:len(layers)] != layers:
                raise ValueError(f"{path} has {np.shape(leaf)[:len(layers)]}"
                                 f" layers, not {layers}")
            for idx in itertools.product(*map(range, layers)):
                port = ".".join([name, *map(str, idx)]) + path[len(name):]
                state[port] = conv(leaf[idx])
    return state


def model_params_from_numpy(cfg, params, *, device=None) -> dict:
    """The state dict of ``models.transformer.Model(cfg)`` holding the
    weights of ``params``: a ``repro`` ``Model.init`` tree (nested dicts of
    numpy arrays), on ``device`` (``None`` -> CUDA).

    Stacked layer leaves are unstacked into per-layer names: ``stack``
    leaves ``[L, …]`` become ``layers.<i>.…``, ``dense_stack`` leaves
    ``dense_layers.<i>.…``, ``enc_stack`` and ``dec_stack`` leaves
    ``enc_layers.<i>.…`` and ``dec_layers.<i>.…`` (nested leaves such as
    ``moe.shared.wg`` keep their path); ``ssm_stack`` leaves
    ``[L, …]`` become ``ssm_stack.<i>.…``; the hybrid's ``groups`` leaves
    ``[n_groups, g, …]`` become ``groups.<a>.<b>.…`` and ``tail`` leaves
    ``[rem, …]`` ``tail.<r>.…``; ``shared_attn`` is one block, unstacked.
    Each leaf keeps its own dtype (``_leaf_converter``)."""
    return _unstack_tree(cfg, params,
                         _leaf_converter(cfg, resolve_device(device)))


def model_on_mesh_from_numpy(cfg, params, mesh, specs: dict, *,
                             device=None, backend: str = "auto"):
    """A ``models.transformer.Model(cfg)`` on ``mesh`` holding the weights
    of ``params`` (a ``repro`` ``Model.init`` tree of numpy arrays): each
    rank reads the same arrays and keeps its shard of each, placed by
    ``specs`` (parameter name -> spec, ``launch/sharding.py::
    param_specs``), on ``device`` (``None`` -> CUDA). The leaves go to
    ``device`` one at a time, each cut to its shard before the next, so
    the device never holds the whole model."""
    from repro_torch import spmd
    from repro_torch.models.transformer import Model

    device = resolve_device(device)
    state = model_params_from_numpy(cfg, params, device="cpu")
    model = Model(cfg, device="meta", backend=backend)
    return spmd.place(model, mesh, specs, state, device)


def model_params_to_numpy(cfg, params) -> dict:
    """The inverse of ``model_params_from_numpy``: the reference's tree
    (nested dicts of numpy arrays, each layer stack's leaves stacked on its
    leading axes) of ``params``, a ``Model`` or a dict of port name ->
    tensor (a state dict, or gradients by parameter name). Each leaf keeps
    its dtype; a bf16 leaf comes out as its ``BF16_BITS``."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    flat = {k: tensor_to_numpy(v) for k, v in params.items()}
    tree = {k: flat.pop(k) for k in ("embed", "ln_f", "unembed")
            if k in flat}
    for key, name, layers in _stack_names(cfg):
        first = ".".join([name, *("0" for _ in layers)])
        sub = {}
        for port in [k for k in flat if k.startswith(first + ".")]:
            path = port[len(first) + 1:].split(".")
            node = sub
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = np.stack([
                flat.pop(".".join([name, *map(str, idx)]) + port[len(first):])
                for idx in itertools.product(*map(range, layers))
            ]).reshape(*layers, *params[port].shape)
        tree[key] = sub
    if flat:
        raise ValueError(f"names outside the config's tree: {sorted(flat)}")
    return tree


def decode_state_from_numpy(cfg, state, *, device=None) -> dict:
    """A copy of a ``repro`` ``Model.init_decode_state`` / ``decode_step``
    state (a dict of numpy arrays) on ``device`` (``None`` -> CUDA), as
    ``Model.decode_step`` takes it: ``pos`` int32, the recurrent states
    ``h`` / ``h_tail`` f32, the caches (``k``, ``v``, MLA's ``ckv``),
    the encoder ``memory`` and the conv buffers in ``cfg.dtype``."""
    conv = _leaf_converter(cfg, resolve_device(device))
    return {k: conv(v) for k, v in state.items()}


def opt_state_from_numpy(cfg, opt, *, device=None) -> OptState:
    """A ``repro`` AdamW ``OptState`` of numpy leaves (``step`` int32,
    ``mu`` and ``nu`` f32 trees shaped like the parameters) as this
    package's ``OptState`` for ``Model(cfg)``: ``step`` a 0-d int32
    tensor, ``mu`` and ``nu`` dicts by parameter name, on ``device``
    (``None`` -> CUDA)."""
    device = resolve_device(device)
    conv = _leaf_converter(cfg, device)
    return OptState(
        step=torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                          device=device),
        mu=_unstack_tree(cfg, opt.mu, conv),
        nu=_unstack_tree(cfg, opt.nu, conv))


def opt_state_to_numpy(cfg, opt: OptState) -> OptState:
    """The inverse of ``opt_state_from_numpy``: ``step`` a 0-d int32 array,
    ``mu`` and ``nu`` the reference's trees of f32 numpy arrays."""
    return OptState(step=tensor_to_numpy(opt.step),
                    mu=model_params_to_numpy(cfg, opt.mu),
                    nu=model_params_to_numpy(cfg, opt.nu))
