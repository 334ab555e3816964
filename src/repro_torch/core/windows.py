"""Resource-availability model (§IV.A.1).

A device's compute is represented, per application configuration, as a
*resource availability list*: ``track_count = device_cores // config.cores``
parallel tracks, each holding disjoint, sorted windows ``[t1, t2)`` of
**guaranteed** availability.  Scheduling queries become containment queries
with early exit; allocation bisects the containing window; windows shorter
than the list's minimum duration are discarded (they can never fit a task).

Two implementations live here:

- :class:`AvailabilityList` — the Python reference used by the simulator.
  Mirrors the paper's C++ structure (linked variable-length windows).
- the fixed-capacity masked-array form (``t1/t2/valid`` of shape
  ``[tracks, MAX_WINDOWS]``, see :func:`to_arrays`), which
  ``core/tensor_state.py`` batches into tensors for the fleet engine.

The abstraction's known accuracy loss (paper §VI.A): a window only records
that *min_cores* are free, not total usage, so freed capacity cannot be
re-inserted — preemption triggers :func:`rebuild` from the active workload.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.tasks import ALL_CONFIGS, DEVICE_CORES, Task, TaskConfig

#: Fixed window capacity per track for the array/JAX form.  Overflowing
#: windows are dropped, which is *sound* (scheduler becomes conservative).
MAX_WINDOWS = 64


@dataclasses.dataclass
class Window:
    t1: float
    t2: float

    @property
    def duration(self) -> float:
        return self.t2 - self.t1

    def contains_slot(self, q1: float, deadline: float, dur: float) -> Optional[float]:
        """Earliest start of a ``dur``-second slot inside this window that
        begins no earlier than ``q1`` and ends by ``deadline``.  Returns the
        start time, or None."""
        start = max(self.t1, q1)
        if start + dur <= min(self.t2, deadline):
            return start
        return None


class AvailabilityList:
    """One resource availability list (one per app config per device)."""

    def __init__(
        self,
        config: TaskConfig,
        device_cores: int = DEVICE_CORES,
        horizon: tuple[float, float] = (0.0, math.inf),
    ):
        self.config = config
        self.min_duration = config.padded_time
        self.cores_per_track = config.cores
        self.track_count = device_cores // config.cores
        self.horizon = horizon
        self.tracks: list[list[Window]] = [
            [Window(*horizon)] for _ in range(self.track_count)
        ]

    # -- queries ----------------------------------------------------------

    def find_slot(
        self, q1: float, deadline: float, dur: Optional[float] = None
    ) -> Optional[tuple[int, int, float]]:
        """Containment query (§IV.A.1): first window that can host a
        ``dur``-second slot within ``[q1, deadline]``.  Early-exits on the
        first hit.  Returns ``(track, window_index, start_time)``."""
        if dur is None:
            dur = self.min_duration
        best: Optional[tuple[int, int, float]] = None
        for ti, track in enumerate(self.tracks):
            for wi, w in enumerate(track):
                if w.t1 >= deadline:
                    break  # windows are sorted; nothing later can fit
                start = w.contains_slot(q1, deadline, dur)
                if start is not None:
                    if best is None or start < best[2]:
                        best = (ti, wi, start)
                    break  # earliest candidate in this track found
        return best

    # -- mutation ---------------------------------------------------------

    def bisect(self, track: int, index: int, s: float, e: float) -> None:
        """Remove ``[s, e)`` from window ``(track, index)``, keeping the ≤2
        remainder windows only if they satisfy the minimum duration."""
        w = self.tracks[track].pop(index)
        assert w.t1 <= s and e <= w.t2, "bisect target must contain the slot"
        pieces = []
        if s - w.t1 >= self.min_duration:
            pieces.append(Window(w.t1, s))
        if w.t2 - e >= self.min_duration:
            pieces.append(Window(e, w.t2))
        self.tracks[track][index:index] = pieces

    def subtract(self, s: float, e: float, occupy_tracks: int) -> None:
        """Background *write* fan-out (§IV.A.1): remove ``[s, e)`` from
        ``occupy_tracks`` tracks of this list (a task holding ``c`` cores
        occupies ``ceil(c / cores_per_track)`` tracks).  Tracks with any
        overlap are consumed first; within a consumed track every overlapping
        window is trimmed (the cores are busy for the whole span)."""
        # Tracks are fungible capacity: consume the ones advertising the
        # MOST availability inside [s, e) first.  (Consuming a track whose
        # windows only graze the span would leave another track's full
        # window standing — an unsound overcommit.)
        def overlap_len(track: list[Window]) -> float:
            return sum(
                max(0.0, min(w.t2, e) - max(w.t1, s)) for w in track
            )

        order = sorted(
            range(self.track_count),
            key=lambda ti: overlap_len(self.tracks[ti]),
            reverse=True,
        )
        remaining = occupy_tracks
        for ti in order:
            if remaining == 0:
                break
            track = self.tracks[ti]
            overlapped = [w for w in track if w.t1 < e and s < w.t2]
            if not overlapped:
                # No availability here to consume; the cores must come out
                # of tracks that still advertise availability.
                continue
            for w in overlapped:
                track.remove(w)
                idx = self._insertion_point(track, w.t1)
                pieces = []
                left = (w.t1, min(w.t2, s))
                right = (max(w.t1, e), w.t2)
                for p1, p2 in (left, right):
                    if p2 - p1 >= self.min_duration:
                        pieces.append(Window(p1, p2))
                track[idx:idx] = pieces
            remaining -= 1

    @staticmethod
    def _insertion_point(track: list[Window], t1: float) -> int:
        for i, w in enumerate(track):
            if w.t1 > t1:
                return i
        return len(track)

    # -- export -------------------------------------------------------------

    def to_arrays(self, max_windows: int = MAX_WINDOWS) -> dict[str, np.ndarray]:
        """Export to the fixed-capacity masked-array form used by the JAX
        query path and the ``window_query`` Pallas kernel."""
        t1 = np.full((self.track_count, max_windows), np.inf, dtype=np.float32)
        t2 = np.full((self.track_count, max_windows), np.inf, dtype=np.float32)
        valid = np.zeros((self.track_count, max_windows), dtype=bool)
        for ti, track in enumerate(self.tracks):
            for wi, w in enumerate(track[:max_windows]):
                t1[ti, wi] = w.t1
                t2[ti, wi] = min(w.t2, np.finfo(np.float32).max)
                valid[ti, wi] = True
        return {"t1": t1, "t2": t2, "valid": valid}


class DeviceAvailability:
    """All availability lists of one device (one per configuration), plus the
    fan-out write / rebuild logic of §IV.A.1."""

    def __init__(
        self,
        device_id: int,
        device_cores: int = DEVICE_CORES,
        horizon: tuple[float, float] = (0.0, math.inf),
        configs: Sequence[TaskConfig] = ALL_CONFIGS,
    ):
        self.device_id = device_id
        self.device_cores = device_cores
        self.horizon = horizon
        self.configs = tuple(configs)
        self.lists = {c.name: AvailabilityList(c, device_cores, horizon) for c in configs}
        #: Active workload — needed for the preemption rebuild.
        self.workload: list[Task] = []

    def list_for(self, config: TaskConfig) -> AvailabilityList:
        return self.lists[config.name]

    def write_task(self, task: Task) -> None:
        """Record an allocation across *every* configuration list (§IV.A.1:
        the expensive background write)."""
        assert task.config is not None
        s, e = task.interval()
        for al in self.lists.values():
            occ = math.ceil(task.config.cores / al.cores_per_track)
            occ = min(occ, al.track_count)
            al.subtract(s, e, occ)
        self.workload.append(task)

    def remove_task(self, task: Task) -> None:
        """Release a task's resources.  Windows cannot be re-inserted (the
        list records min-core guarantees, not totals) ⇒ full rebuild."""
        self.workload = [t for t in self.workload if t.task_id != task.task_id]
        self.rebuild()

    def rebuild(self, now: Optional[float] = None) -> None:
        """Reconstruct every availability list from the active workload
        (§IV.A.1 / §IV.B.3)."""
        horizon = (now, self.horizon[1]) if now is not None else self.horizon
        self.lists = {
            c.name: AvailabilityList(c, self.device_cores, horizon)
            for c in self.configs
        }
        for task in self.workload:
            s, e = task.interval()
            for al in self.lists.values():
                occ = math.ceil(task.config.cores / al.cores_per_track)
                occ = min(occ, al.track_count)
                al.subtract(s, e, occ)

    def prune(self, now: float) -> None:
        """Drop completed work from the workload (bookkeeping only)."""
        self.workload = [t for t in self.workload if t.end_time is None or t.end_time > now]

