"""Network-link discretisation (§IV.A.2).

The (single, shared) network link is modelled as a sequence of *buckets*,
each a time window that can hold ``capacity`` communication tasks of the
base transfer unit ``D`` — the transfer time of the largest task input at
the current bandwidth estimate:

    D = max_image_bytes * 8 / bandwidth_bps

Layout (Fig. 3): starting from the *current time of reasoning* ``t_r``
(now rounded up to a multiple of D), the first ``n_base`` buckets have
capacity 1 (high accuracy near-future), after which ``n_exp`` buckets grow
exponentially in capacity (bucket k holds 2^(k+1) transfers and spans
2^(k+1)·D) to bound memory over a long horizon.

A timestamp maps to a bucket index in O(1) via the paper's formula:

    base_index = ((t_p - t_r) + (D - ((t_p - t_r) % D))) / D      # ceil
    index      = base_index                       if base_index < n_base
                 floor(log2(base_index)) + c      otherwise

Reservation walks forward from that index to the first non-full bucket.
When the bandwidth estimate changes, the whole discretisation is rebuilt at
the new ``D`` and existing reservations *cascade* into it (§IV.A.2); items
whose window has already passed are dropped.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.tasks import MAX_IMAGE_BYTES


@dataclasses.dataclass
class CommItem:
    """A reserved communication task (one task-input transfer)."""

    task_id: int
    timestamp: float  # the time the transfer was requested for


@dataclasses.dataclass
class Bucket:
    t1: float
    t2: float
    capacity: int
    items: list[CommItem] = dataclasses.field(default_factory=list)

    @property
    def full(self) -> bool:
        return len(self.items) >= self.capacity


class NetworkLink:
    """Discretised network link."""

    def __init__(
        self,
        bandwidth_bps: float,
        now: float = 0.0,
        # Base buckets must cover at least one bandwidth-update period at
        # fine resolution (they are rebuilt every update); the exponential
        # tail bounds memory for the far horizon (§IV.A.2).
        n_base: int = 256,
        n_exp: int = 12,
        transfer_bytes: int = MAX_IMAGE_BYTES,
    ):
        self.bandwidth_bps = float(bandwidth_bps)
        self.n_base = n_base
        self.n_exp = n_exp
        self.transfer_bytes = transfer_bytes
        #: Base unit of transfer (seconds).
        self.D = transfer_bytes * 8.0 / self.bandwidth_bps
        #: Current time of reasoning: now rounded *up* to a multiple of D.
        self.t_r = math.ceil(now / self.D) * self.D if self.D > 0 else now
        self.buckets: list[Bucket] = []
        t = self.t_r
        for _ in range(n_base):
            self.buckets.append(Bucket(t, t + self.D, capacity=1))
            t += self.D
        for k in range(n_exp):
            cap = 2 ** (k + 1)
            self.buckets.append(Bucket(t, t + cap * self.D, capacity=cap))
            t += cap * self.D

    # -- O(1) index query ---------------------------------------------------

    def index_of(self, t_p: float) -> int:
        """Paper's closed-form bucket index for timestamp ``t_p``.  Negative
        result ⇒ the timestamp is already in the past (transfer done)."""
        if t_p < self.t_r:
            if t_p < self.t_r - self.D:
                return -1
            return 0  # within the rounding slack of t_r
        delta = t_p - self.t_r
        rem = delta % self.D
        base_index = (delta + (self.D - rem)) / self.D  # ceil(delta/D), +1 on exact
        if base_index < self.n_base:
            return int(math.floor(base_index))
        # Exponential region.  Bucket k (k=0..) starts at offset
        # n_base + (2^(k+1) - 2) base units; invert with log2.
        units_past_base = base_index - self.n_base
        k = int(math.floor(math.log2(units_past_base / 2.0 + 1.0)))
        return min(self.n_base + k, len(self.buckets) - 1)

    def index_of_paper(self, t_p: float) -> int:
        """The formula exactly as printed in the paper (floor(log2(bi)+2)).
        Kept for fidelity/tests; :meth:`index_of` corrects the offset so the
        returned bucket actually contains ``t_p`` (the printed formula is
        only exact when n_base ≈ 2: with larger n_base it indexes a bucket
        *earlier* than t_p, which reservation's forward walk then skips)."""
        delta = t_p - self.t_r
        if delta < 0:
            return -1
        rem = delta % self.D
        base_index = (delta + (self.D - rem)) / self.D
        if base_index < self.n_base:
            return int(math.floor(base_index))
        return int(math.floor(math.log2(base_index) + 2))

    # -- reservation --------------------------------------------------------

    def reserve(self, task_id: int, t_p: float) -> Optional[tuple[float, float]]:
        """Reserve one transfer at/after ``t_p``.  Walks forward from the
        indexed bucket to the first non-full one (§IV.A.2).  Returns the
        bucket's time window, or None if the horizon is exhausted."""
        idx = self.index_of(t_p)
        if idx < 0:
            idx = 0
        while idx < len(self.buckets):
            b = self.buckets[idx]
            if not b.full and b.t2 > t_p:
                b.items.append(CommItem(task_id, max(t_p, b.t1)))
                return (b.t1, b.t2)
            idx += 1
        return None

    def release(self, task_id: int) -> None:
        for b in self.buckets:
            b.items = [it for it in b.items if it.task_id != task_id]

    def occupancy(self) -> int:
        return sum(len(b.items) for b in self.buckets)

    # -- cascade rebuild ------------------------------------------------------

    def cascade_from(self, old: "NetworkLink") -> int:
        """Downshift every reservation of ``old`` into this (fresh) link
        (§IV.A.2).  Items whose query index is negative have completed and
        are excluded.  Returns the number of items carried over."""
        carried = 0
        for b in old.buckets:
            for item in b.items:
                if item.timestamp < self.t_r - self.D:
                    continue  # already completed
                if self.reserve(item.task_id, item.timestamp) is not None:
                    carried += 1
        return carried

    # -- export ---------------------------------------------------------------

    def to_arrays(self) -> dict[str, np.ndarray]:
        n = len(self.buckets)
        return {
            "t1": np.array([b.t1 for b in self.buckets], dtype=np.float32),
            "t2": np.array([b.t2 for b in self.buckets], dtype=np.float32),
            "capacity": np.array([b.capacity for b in self.buckets], dtype=np.int32),
            "used": np.array([len(b.items) for b in self.buckets], dtype=np.int32),
        }


# ---------------------------------------------------------------------------
# Tensor functional form (the JAX package's ``index_of_jax``/``reserve_jax``)
# ---------------------------------------------------------------------------

import torch


def index_of_torch(t_p, t_r, D, n_base, n_buckets):
    """Closed-form bucket index, vectorised (mirrors NetworkLink.index_of);
    the counterpart of ``index_of_jax``, equal to it on the same f32 inputs.

    Every scalar is rounded to f32 first, as JAX's weak types are. ``%`` is
    ``fmod``, exact, and equal to JAX's floor-mod on the non-negative
    operand; the division is tensor by tensor (torch may turn a division by
    a scalar into a product with its reciprocal); ``log2`` is ``log(x) /
    log(2)``, as ``jnp.log2`` computes it, so its floor agrees at the powers
    of two where ``torch.log2`` does not always."""
    t_p = torch.as_tensor(t_p, dtype=torch.float32)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=t_p.device)
    D = f32(D)
    delta = t_p - f32(t_r)
    pos = torch.clamp(delta, min=0.0)
    base_index = torch.ceil(pos / D) + (torch.fmod(pos, D) == 0.0)
    units_past_base = base_index - f32(n_base)
    k = torch.floor(torch.log(units_past_base / f32(2.0) + 1.0)
                    / torch.log(f32(2.0)))
    idx = torch.where(base_index < n_base, torch.floor(base_index),
                      f32(n_base) + k)
    idx = torch.where(delta < -D, -1.0, torch.clamp(idx, min=0.0))
    return torch.clamp(idx, max=f32(n_buckets - 1)).to(torch.int32)


def reserve_torch(t1, t2, capacity, used, t_p):
    """First non-full bucket at/after ``t_p`` as a masked first-index
    argmax (the counterpart of ``reserve_jax``): ``(found, idx)``, with
    ``idx`` int32 and 0 where no bucket is free, as ``jnp.argmax`` gives."""
    ok = (used < capacity) & (t2 > torch.as_tensor(
        t_p, dtype=torch.float32, device=t2.device))
    return ok.any(), ok.to(torch.int8).argmax().to(torch.int32)
