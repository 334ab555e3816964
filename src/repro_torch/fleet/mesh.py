"""Devices of the sharded fleet engine.

Counterpart of ``repro/fleet/mesh.py``. The fleet's batch axis is
embarrassingly parallel — replicas never interact — so a batch splits
into ``B / shards`` rows a device, each shard runs the unsharded tick on
its slice, and a sweep reduces each batch to per-cell moments on the
device (``metrics.cell_moments``), so only O(cells × metrics) numbers
cross to the host.

Where the reference builds a 1-D ``shard_map`` mesh over
``jax.devices()``, the port names one torch device a shard: the first
``shards`` CUDA devices on the card, or, on the host, the CPU device
``shards`` times over (the counterpart of the reference's
``--xla_force_host_platform_device_count``, so the CPU tests run the
sharded path at 1 and 2 shards).
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device

#: the one axis name the fleet subsystem shards over (the reference's).
FLEET_AXIS = "fleet"


def available_shards() -> int:
    """CUDA devices usable as fleet shards in this process."""
    return torch.cuda.device_count()


def fleet_devices(shards: int, device=None) -> list[torch.device]:
    """The device of each of ``shards`` shards, for a fleet on ``device``
    (``None`` -> CUDA): CUDA devices 0 .. shards-1, or ``device`` itself
    ``shards`` times for a host device."""
    device = resolve_device(device)
    if shards < 1:
        raise ValueError(f"mesh_shards must be >= 1, got {shards}")
    if device.type != "cuda":
        return [device] * shards
    n = available_shards()
    if shards > n:
        raise ValueError(
            f"mesh_shards={shards} but only {n} CUDA device(s) are visible")
    return [torch.device("cuda", i) for i in range(shards)]


def shard_pad(batch: int, shards: int) -> int:
    """Rows to append so ``batch`` splits evenly across ``shards``."""
    return (-batch) % shards
