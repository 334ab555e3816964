"""Carry fleet state across from the JAX package, and back.

``fleet_from_numpy`` takes a ``repro`` ``FleetState`` whose leaves are numpy
arrays (or any object with the same field names, this package's
``FleetState`` included) and builds this package's state from copies of
them, so that both engines can start from the same mid-run state.
``fleet_to_numpy`` and ``stats_to_numpy`` go the other way. This module
imports neither package: it reads fields by name.
"""

from __future__ import annotations

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
