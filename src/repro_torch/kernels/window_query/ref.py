"""Plain PyTorch versions of the window-query kernels: the §IV.B.2
multi-containment query as a masked min-reduce over each device's T·W
windows (``core/windows.py::find_slot_arrays`` over devices).

Counterpart of ``repro/kernels/window_query/ref.py``. ``BIG`` is the
kernel's own sentinel, not ``tensor_state.BIG`` (1e30): a device with no
feasible window returns ``found = 0`` and ``start = BIG``.

Python scalars are rounded to f32 before they meet a tensor, as JAX's weak
types round them, so ``start + dur`` is the f32 sum the reference makes.
"""

from __future__ import annotations

import torch

BIG = 3.0e38


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def window_query_ref(t1, t2, valid, q1, deadline, dur):
    """t1, t2, valid: [Dev,T,W]; q1, deadline, dur: scalars
    -> (found [Dev] i32, start [Dev] f32)."""
    dev = t1.device
    start = torch.maximum(t1, _f32(q1, dev))
    feasible = valid.bool() & (
        start + _f32(dur, dev) <= torch.minimum(t2, _f32(deadline, dev)))
    key = torch.where(feasible, start, BIG).reshape(t1.shape[0], -1)
    best = key.amin(1)
    return (best < BIG).to(torch.int32), best


def window_query_batched_ref(t1, t2, valid, q1, deadline, dur):
    """t1, t2, valid: [B,Dev,T,W]; q1, deadline, dur: scalars or
    broadcastable to [B,Dev] -> (found [B,Dev] i32, start [B,Dev] f32)."""
    B, Dev = t1.shape[:2]
    dev = t1.device
    q1, deadline, dur = (_f32(x, dev).expand(B, Dev)[..., None, None]
                         for x in (q1, deadline, dur))
    start = torch.maximum(t1, q1)
    feasible = valid.bool() & (start + dur <= torch.minimum(t2, deadline))
    key = torch.where(feasible, start, BIG).reshape(B, Dev, -1)
    best = key.amin(-1)
    return (best < BIG).to(torch.int32), best
