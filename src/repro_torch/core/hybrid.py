"""HYB — the contextual multi-scheduler the paper proposes as future work
(§VII: "utilising a more accurate approach under lightly loaded conditions
and switching to light-weight scheduling abstraction models in times of
higher network load").

Design insight (beyond-paper): the accuracy-vs-performance trade the paper
measured is partly an artifact of WHERE the exact state lived in their
prior system.  RAS already keeps every device's active workload
controller-side (it needs it for preemption rebuilds) — so an *exact*
overlapping-range query over those lists costs only its operation count,
no synchronisation round-trips.  HYB therefore:

- at LIGHT load (few active tasks network-wide): answers placement queries
  with the exact sweep over ``DeviceAvailability.workload`` — WPS-grade
  accuracy at controller-local cost;
- at HEAVY load (the sweep's op count would exceed the window query's):
  falls back to the paper's containment query on the availability lists;
- maintains ONE set of structures (the RAS ones) for both paths — commits
  always fan out to the availability lists, so switching is free.

The load signal is the thing the cost actually depends on: the number of
active+queued tasks in the network.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.scheduler import OpCounter, RASScheduler
from repro_torch.core.tasks import Task, TaskState


class HybridScheduler(RASScheduler):
    name = "HYB"

    #: switch to the abstraction when the network holds more active tasks
    #: than this (the exact sweep is O(devices * tasks^2); the containment
    #: query is O(devices * windows)).
    load_threshold = 10

    def _network_load(self) -> int:
        return sum(len(d.workload) for d in self.devices)

    def _exact_mode(self) -> bool:
        return self._network_load() <= self.load_threshold

    # -- exact query path ----------------------------------------------------

    def _exact_device_slots(self, device: int, q1: float, deadline: float,
                            dur: float, cores: int, n_max: int,
                            c: OpCounter) -> list[float]:
        """Up to ``n_max`` earliest exact starts on ``device`` — an
        overlapping-range sweep over the controller-local workload (no sync
        round-trip).  Each found slot is added as a phantom interval so the
        next one cannot overcommit the device."""
        dev = self.devices[device]
        intervals = [
            (t.start_time, t.end_time, t.config.cores)
            for t in dev.workload
            if t.state in (TaskState.ALLOCATED, TaskState.RUNNING)
            and t.start_time is not None
        ]
        found: list[float] = []
        for _ in range(n_max):
            slot = None
            candidates = [q1] + sorted(
                e for _, e, _ in intervals if q1 < e < deadline
            )
            for s in candidates:
                if s + dur > deadline:
                    break
                events = []
                for ts, te, tc in intervals:
                    c.charge()
                    if ts < s + dur and s < te:
                        events.append((max(ts, s), tc))
                        events.append((min(te, s + dur), -tc))
                events.sort()
                cur = peak = 0
                for _, delta in events:
                    cur += delta
                    peak = max(peak, cur)
                if peak + cores <= self.device_cores:
                    slot = s
                    break
            if slot is None:
                break
            found.append(slot)
            intervals.append((slot, slot + dur, cores))
        return found

    # -- overridden query points -----------------------------------------------

    def _owner_device(self, al):
        for dev in self.devices:
            if al in dev.lists.values():
                return dev
        return None

    def _find_slot_counted(self, al, q1, deadline, dur, c: OpCounter):
        dev = self._owner_device(al) if self._exact_mode() else None
        if dev is None:
            return super()._find_slot_counted(al, q1, deadline, dur, c)
        slots = self._exact_device_slots(
            dev.device_id, q1, deadline, dur, al.config.cores, 1, c
        )
        return None if not slots else (0, 0, slots[0])

    def _all_slots_counted(self, al, q1, deadline, dur, c: OpCounter):
        dev = self._owner_device(al) if self._exact_mode() else None
        if dev is None:
            return super()._all_slots_counted(al, q1, deadline, dur, c)
        slots = self._exact_device_slots(
            dev.device_id, q1, deadline, dur, al.config.cores,
            al.track_count, c
        )
        return [(0, 0, s, deadline) for s in slots]
