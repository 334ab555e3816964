"""Fleet state: B independent scheduler replicas as one set of tensors.

`FleetState` stacks `SchedState` (core/tensor_state.py) along a leading
batch axis — every window/link tensor gains a `[B, ...]` dimension, and the
engine advances all replicas per tick. The field names and dtypes are those
of the JAX package's `FleetState` (``carry.py`` converts between the two).

    link_free    f32[B]       serial-link FIFO head per replica
    now          f32[B]       per-replica simulation clock
    rq_deadline  f32[B, R]    bounded victim re-queue (§IV.B.3)
    rq_src       i32[B, R]
    rq_valid     bool[B, R]
    vc_start     f32[B, Dev]  one-deep victim cache: the most recently
    vc_end       f32[B, Dev]  committed LP placement per device
    vc_deadline  f32[B, Dev]
    vc_src       i32[B, Dev]
    vc_valid     bool[B, Dev]

Every replica owns its memory: the placement kernel commits in place, so
replicas never share storage through a broadcast view.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core.scheduler import RASScheduler
from repro_torch.core.tasks import ALL_CONFIGS, DEVICE_CORES
from repro_torch.core.tensor_state import SchedState, export_state


class FleetState(NamedTuple):
    sched: SchedState         # every leaf carries a leading [B] axis
    link_free: torch.Tensor   # [B]
    now: torch.Tensor         # [B]
    # victim re-queue buffer (preempted LP tasks awaiting re-placement)
    rq_deadline: torch.Tensor  # f32[B, R]
    rq_src: torch.Tensor       # i32[B, R]
    rq_valid: torch.Tensor     # bool[B, R]
    # per-device cache of the most recent committed LP placement
    vc_start: torch.Tensor     # f32[B, Dev]
    vc_end: torch.Tensor       # f32[B, Dev]
    vc_deadline: torch.Tensor  # f32[B, Dev]
    vc_src: torch.Tensor       # i32[B, Dev]
    vc_valid: torch.Tensor     # bool[B, Dev]


def broadcast_state(st: SchedState, batch: int) -> SchedState:
    """Tile one replica's SchedState along a new leading batch axis (a
    copy per replica, not a view)."""
    return SchedState(*(
        x.unsqueeze(0).expand((batch,) + tuple(x.shape)).contiguous()
        for x in st
    ))


def stack_states(states: list[SchedState]) -> SchedState:
    """Stack per-replica SchedStates (e.g. mid-run snapshots) into a batch."""
    return SchedState(*(torch.stack(xs) for xs in zip(*states)))


def make_fleet(batch: int, n_devices: int = 4, bandwidth_bps: float = 20e6,
               *, max_windows: int = 16, requeue_slots: int = 4,
               device=None) -> FleetState:
    """A pristine B-replica fleet on ``device`` (``None`` -> CUDA): every
    device fully available from t=0.

    Built by exporting a fresh `RASScheduler`, so the window/track/link
    layout is byte-identical to the reference path. ``requeue_slots`` must
    match ``FleetParams.requeue_slots`` of the engine that runs the fleet.
    """
    device = resolve_device(device)
    base = export_state(
        RASScheduler(n_devices, bandwidth_bps), max_windows=max_windows,
        device=device,
    )

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return FleetState(
        sched=broadcast_state(base, batch),
        link_free=zeros((batch,), torch.float32),
        now=zeros((batch,), torch.float32),
        rq_deadline=zeros((batch, requeue_slots), torch.float32),
        rq_src=zeros((batch, requeue_slots), torch.int32),
        rq_valid=zeros((batch, requeue_slots), torch.bool),
        vc_start=zeros((batch, n_devices), torch.float32),
        vc_end=zeros((batch, n_devices), torch.float32),
        vc_deadline=zeros((batch, n_devices), torch.float32),
        vc_src=zeros((batch, n_devices), torch.int32),
        vc_valid=zeros((batch, n_devices), torch.bool),
    )


def fleet_shape(fs: FleetState) -> tuple[int, int, int, int, int]:
    """(B, Dev, CFG, T, W) of a fleet."""
    return tuple(fs.sched.win_t1.shape)


def track_counts() -> dict[str, int]:
    return {c.name: DEVICE_CORES // c.cores for c in ALL_CONFIGS}
