"""Carry fleet state across from the JAX package, and back.

``fleet_from_numpy`` takes a ``repro`` ``FleetState`` whose leaves are numpy
arrays (or any object with the same field names, this package's
``FleetState`` included) and builds this package's state from copies of
them, so that both engines can start from the same mid-run state.
``fleet_to_numpy`` and ``stats_to_numpy`` go the other way.
``model_params_from_numpy`` takes a ``repro`` ``Model.init`` parameter tree
of numpy arrays and gives this package's ``Model`` state. This module
imports neither package: it reads fields and keys by name.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.tensor_state import SchedState
from repro_torch.fleet.metrics import _host
from repro_torch.fleet.metrics import stats_to_numpy  # noqa: F401 (re-export)
from repro_torch.fleet.state import FleetState
from repro_torch.models.transformer import check_supported

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool}


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unexpected leaf dtype {a.dtype}")
    return torch.tensor(a, dtype=_DTYPES[a.dtype], device=device)


def fleet_from_numpy(d, *, device=None) -> FleetState:
    """A copy of fleet state ``d`` on ``device`` (``None`` -> CUDA)."""
    device = resolve_device(device)
    sched = SchedState(*(
        _tensor(getattr(d.sched, f), device) for f in SchedState._fields
    ))
    return FleetState(sched, *(
        _tensor(getattr(d, f), device) for f in FleetState._fields[1:]
    ))


def fleet_to_numpy(fs: FleetState) -> FleetState:
    """The same fields, as numpy arrays on the host."""
    return FleetState(SchedState(*map(_host, fs.sched)),
                      *map(_host, fs[1:]))


def model_params_from_numpy(cfg, params, *, device=None) -> dict:
    """The state dict of ``models.transformer.Model(cfg)`` holding the
    weights of ``params``: a ``repro`` ``Model.init`` tree (nested dicts of
    numpy arrays, the layer leaves stacked on a leading axis under
    ``stack``), on ``device`` (``None`` -> CUDA), in ``cfg.dtype``.

    ``jax.device_get`` gives bf16 leaves as ``ml_dtypes.bfloat16`` arrays,
    which ``torch.from_numpy`` refuses: every leaf goes through float32,
    which holds each bf16 value exactly, and then to ``cfg.dtype``."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def conv(x):
        a = np.ascontiguousarray(np.asarray(x).astype(np.float32))
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    state = {"embed": conv(params["embed"]), "ln_f": conv(params["ln_f"])}
    if not cfg.tie_embeddings:
        state["unembed"] = conv(params["unembed"])
    stack = params["stack"]
    for group in ("attn", "mlp"):
        for name, leaf in stack[group].items():
            if np.shape(leaf)[0] != cfg.n_layers:
                raise ValueError(f"stack/{group}/{name} has "
                                 f"{np.shape(leaf)[0]} layers, not "
                                 f"{cfg.n_layers}")
    for i in range(cfg.n_layers):
        state[f"layers.{i}.ln1"] = conv(stack["ln1"][i])
        state[f"layers.{i}.ln2"] = conv(stack["ln2"][i])
        for group in ("attn", "mlp"):
            for name, leaf in stack[group].items():
                state[f"layers.{i}.{group}.{name}"] = conv(leaf[i])
    return state
