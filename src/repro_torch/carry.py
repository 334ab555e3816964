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
``decode_state_from_numpy`` does the same for a decode state. This module
imports neither package: it reads fields and keys by name.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.tensor_state import SchedState
from repro_torch.fleet.metrics import _host
from repro_torch.fleet.metrics import stats_to_numpy  # noqa: F401 (re-export)
from repro_torch.fleet.state import FleetState

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
    each bf16 value exactly."""
    dtype = getattr(torch, cfg.dtype)

    def conv(x):
        a = np.asarray(x)
        if a.dtype == np.int32:
            return torch.from_numpy(np.array(a)).to(device)
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
    conv = _leaf_converter(cfg, resolve_device(device))
    state = {"embed": conv(params["embed"]), "ln_f": conv(params["ln_f"])}
    if not cfg.tie_embeddings:
        state["unembed"] = conv(params["unembed"])

    def unstack(tree, layers: tuple, name: str):
        """Leaves stacked on leading axes of sizes ``layers``, one entry
        per index."""
        for path, leaf in _leaves(tree, name):
            if np.shape(leaf)[:len(layers)] != layers:
                raise ValueError(f"{path} has {np.shape(leaf)[:len(layers)]}"
                                 f" layers, not {layers}")
            for idx in itertools.product(*map(range, layers)):
                key = ".".join([name, *map(str, idx)]) + path[len(name):]
                state[key] = conv(leaf[idx])

    if cfg.arch_type == "ssm":
        unstack(params["ssm_stack"], (cfg.n_layers,), "ssm_stack")
    elif cfg.arch_type == "hybrid":
        g = cfg.shared_attn_every
        n_groups, rem = divmod(cfg.n_layers, g)
        unstack(params["groups"], (n_groups, g), "groups")
        if rem:
            unstack(params["tail"], (rem,), "tail")
        unstack(params["shared_attn"], (), "shared_attn")
    elif cfg.is_encoder_decoder:
        unstack(params["enc_stack"], (cfg.n_encoder_layers,), "enc_layers")
        unstack(params["dec_stack"], (cfg.n_layers,), "dec_layers")
    else:
        nd = cfg.first_dense_layers if cfg.uses_moe else 0
        if nd:
            unstack(params["dense_stack"], (nd,), "dense_layers")
        unstack(params["stack"], (cfg.n_layers - nd,), "layers")
    return state


def decode_state_from_numpy(cfg, state, *, device=None) -> dict:
    """A copy of a ``repro`` ``Model.init_decode_state`` / ``decode_step``
    state (a dict of numpy arrays) on ``device`` (``None`` -> CUDA), as
    ``Model.decode_step`` takes it: ``pos`` int32, the recurrent states
    ``h`` / ``h_tail`` f32, the caches (``k``, ``v``, MLA's ``ckv``),
    the encoder ``memory`` and the conv buffers in ``cfg.dtype``."""
    conv = _leaf_converter(cfg, resolve_device(device))
    return {k: conv(v) for k, v in state.items()}
