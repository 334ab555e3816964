"""Discrete-event simulation of the waste-classification testbed (§V).

Replays the paper's experiment layout under a deterministic simulated
clock: ``n_devices`` edge devices each release one frame per
``FRAME_PERIOD``; trace entries decide whether the frame carries an HP task
and how many LP DNN tasks it spawns; a centralised controller runs the
scheduler (RAS or WPS) **serially**, so scheduling latency both delays the
scheduled tasks and queues subsequent requests (the paper's core
accuracy-vs-performance mechanism).

Execution realism:
- Actual transfer times integrate the *true* piecewise link bandwidth
  (congestion bursts, §VI.C); a transfer overrunning its reserved window
  pushes the task start late and can violate the deadline — the paper's
  "erroneous task placement" under stale estimates.
- Ping-based probes collide with in-flight transfers with probability
  equal to the measured link busy-fraction; collided pings read a
  catastrophically low bandwidth (they queue behind an image), which is
  what biases high-frequency estimation down (§VI.B).
- Preempted tasks re-enter LP scheduling only after the preempting HP task
  finishes its preemption processing (§VI.A reallocation path).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Optional

import numpy as np

from repro_torch.core.scheduler import RASScheduler
from repro_torch.core.tasks import (
    FRAME_PERIOD,
    Frame,
    LPRequest,
    Priority,
    Task,
    TaskState,
    reset_task_ids,
    PROBE_PING_BYTES,
    PROBE_PING_COUNT,
)
from repro_torch.core.wps import WPSScheduler
from repro_torch.obs.events import EventLog
from repro_torch.sim.congestion import CongestionModel, LinkActivity
from repro_torch.sim.metrics import Metrics
from repro_torch.sim.traces import Trace, generate_trace


@dataclasses.dataclass
class ExperimentConfig:
    scheduler: str = "ras"               # "ras" | "wps"
    trace: str = "weighted2"             # uniform | weighted{1..4}
    n_frames: int = 95                   # ≈ 30 simulated minutes
    n_devices: int = 4
    nominal_bw_bps: float = 20e6         # 802.11n effective throughput
    bw_interval: float = 30.0            # probe period (§VI.B sweeps this)
    bw_adaptive: bool = False            # paper §VII future work 2: vary the
    bw_adapt_min: float = 5.0            # probe frequency with observed
    bw_adapt_max: float = 60.0           # estimate volatility
    duty_cycle: float = 0.0              # congestion generator (§VI.C)
    congestion_intensity: float = 0.8   # Packet_MMAP generator saturates
                                         # the link during bursts (SSVI.C;
                                         # calibrated: Table II 4-core shift
                                         # 0%->12.3%, ours 0%->13%)
    bw_walk_sigma: float = 0.05          # Wi-Fi throughput random walk
    proc_jitter: float = 0.01            # run-time jitter σ (SSV pads with the
                                         # benchmark stddev, so overruns are rare)
    hp_deadline: float = 3.0
    lp_deadline_factor: float = 1.2      # deadline = release + f × FRAME_PERIOD
                                         # (18.86 s IS the minimum viable
                                         # completion time, SSV — slack is thin)
    stagger: float = 1.0                 # conveyor-belt phase offset (0=aligned)
    op_cost: Optional[float] = None   # None → scheduler-family default
    seed: int = 0

    def make_scheduler(self):
        from repro_torch.core.hybrid import HybridScheduler

        cls = {"ras": RASScheduler, "wps": WPSScheduler,
               "hyb": HybridScheduler}[self.scheduler]
        return cls(
            self.n_devices,
            self.nominal_bw_bps,
            op_cost=self.op_cost,
            seed=self.seed,
        )


class DeviceExec:
    """Execution-side truth of one device: the inference manager cannot
    oversubscribe cores, so a task whose scheduled start collides with
    still-running work is delayed until enough cores free up.  Exactly-packed
    schedules (WPS's accurate ones) therefore cascade run-time jitter, while
    schedules with conservative slack (RAS's window abstraction) absorb it."""

    def __init__(self, cores: int):
        self.cores = cores
        self.intervals: list[list] = []  # [start, end, cores, task_id]

    def earliest_start(self, s: float, dur: float, cores: int) -> float:
        candidates = [s] + sorted(iv[1] for iv in self.intervals if iv[1] > s)
        for cand in candidates:
            if self._max_usage(cand, cand + dur) + cores <= self.cores:
                return cand
        return candidates[-1] if candidates else s

    def _max_usage(self, s: float, e: float) -> int:
        events = []
        for iv in self.intervals:
            if iv[0] < e and s < iv[1]:
                events.append((max(iv[0], s), iv[2]))
                events.append((min(iv[1], e), -iv[2]))
        events.sort()
        cur = peak = 0
        for _, d in events:
            cur += d
            peak = max(peak, cur)
        return peak

    def occupy(self, s: float, e: float, cores: int, task_id: int) -> None:
        self.intervals.append([s, e, cores, task_id])

    def release(self, task_id: int, at: float) -> None:
        """Truncate (preemption) or drop a task's execution interval."""
        for iv in self.intervals:
            if iv[3] == task_id:
                iv[1] = min(iv[1], max(at, iv[0]))

    def prune(self, now: float) -> None:
        self.intervals = [iv for iv in self.intervals if iv[1] > now]


class Simulation:
    def __init__(self, cfg: ExperimentConfig, trace: Optional[Trace] = None,
                 event_log: Optional[EventLog] = None):
        self.cfg = cfg
        #: opt-in structured event log (obs/events.py); None = zero cost
        self.obs = event_log
        reset_task_ids()
        self.trace = trace or generate_trace(
            cfg.trace, cfg.n_frames, cfg.n_devices, seed=cfg.seed
        )
        self.sched = cfg.make_scheduler()
        self.congestion = CongestionModel(
            cfg.nominal_bw_bps,
            duty_cycle=cfg.duty_cycle,
            period=cfg.bw_interval,
            intensity=cfg.congestion_intensity,
            walk_sigma=cfg.bw_walk_sigma,
            horizon=cfg.n_frames * FRAME_PERIOD + 8 * FRAME_PERIOD,
            seed=cfg.seed,
            probe_period=cfg.bw_interval,
        )
        self.exec_devices = [DeviceExec(4) for _ in range(cfg.n_devices)]
        self.link_activity = LinkActivity()
        self.metrics = Metrics()
        self.frames: list[Frame] = []
        self.rng = np.random.default_rng(cfg.seed + 1)
        self._heap: list = []
        self._seq = itertools.count()
        self.controller_free = 0.0
        self.now = 0.0
        self.horizon = cfg.n_frames * FRAME_PERIOD + 4 * FRAME_PERIOD

    # -- event plumbing -----------------------------------------------------

    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    # -- main loop ------------------------------------------------------------

    def run(self) -> Metrics:
        cfg = self.cfg
        for f in range(cfg.n_frames):
            base = f * FRAME_PERIOD
            for d in range(cfg.n_devices):
                # independent conveyor belts: staggered sampling phases
                t = base + d * (FRAME_PERIOD / cfg.n_devices) * cfg.stagger
                v = int(self.trace.entries[f, d])
                if v >= 0:
                    self._push(t, "frame", (f, d, v))
            self._push(base, "housekeeping", None)
        if cfg.bw_adaptive:
            self._adaptive_interval = cfg.bw_interval
            self._push(cfg.bw_interval, "probe", None)
        else:
            k = 1
            while k * cfg.bw_interval < self.horizon:
                self._push(k * cfg.bw_interval, "probe", None)
                k += 1

        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            if t > self.horizon:
                break
            self.now = t
            getattr(self, f"_on_{kind}")(t, payload)

        self.metrics.finalize_frames(self.frames)
        self.metrics.controller_busy_time = self._controller_busy
        return self.metrics

    _controller_busy = 0.0

    def _controller_gate(self, t: float) -> Optional[float]:
        """Serial controller: if busy, requeue the event; else return t."""
        if t < self.controller_free - 1e-12:
            return None
        return t

    def _charge_controller(self, t: float, latency: float) -> float:
        self.controller_free = t + latency
        self._controller_busy += latency
        return self.controller_free

    # -- events -----------------------------------------------------------------

    def _on_frame(self, t: float, payload) -> None:
        f, d, v = payload
        frame = Frame(frame_id=len(self.frames), device=d, release_time=t)
        self.frames.append(frame)
        hp = Task(
            Priority.HIGH,
            source_device=d,
            release_time=t,
            deadline=t + self.cfg.hp_deadline,
            frame_id=frame.frame_id,
        )
        frame.hp_task = hp
        if self.obs:
            self.obs.emit(t, "frame_release", device=d,
                          frame_id=frame.frame_id, info={"value": v})
        self._push(t, "sched_hp", (hp, frame, v))

    def _on_sched_hp(self, t: float, payload) -> None:
        hp, frame, v = payload
        te = self._controller_gate(t)
        if te is None:
            self._push(self.controller_free, "sched_hp", payload)
            return
        res = self.sched.schedule_hp(hp, te)
        commit = self._charge_controller(te, res.latency)
        if res.preempted:
            self.metrics.hp_preempt_latency.add(res.latency)
            for victim in res.preempted:
                self.metrics.lp_preempted += 1
                victim.realloc_count += 1
                bump = getattr(victim, "epoch", 0) + 1
                victim.epoch = bump
                if self.obs:
                    self.obs.emit(
                        commit, "preempt", priority="LP",
                        device=victim.device if victim.device is not None
                        else -1,
                        task_id=victim.task_id, frame_id=victim.frame_id,
                        info={"deadline": round(victim.deadline, 6),
                              "by_task": hp.task_id},
                    )
                # Execution truth: the victim's cores free at preemption time.
                if victim.device is not None:
                    self.exec_devices[victim.device].release(victim.task_id, commit)
                # Reallocation begins only after the HP preemption completes.
                req = LPRequest([victim], victim.source_device, commit)
                self._push(commit, "sched_lp", (req, None, True))
        if not res.success:
            self.metrics.hp_failed += 1
            if self.obs:
                self.obs.emit(te, "hp_admit_fail", priority="HP",
                              device=hp.source_device, task_id=hp.task_id,
                              frame_id=frame.frame_id)
            return
        if res.preempted:
            self.metrics.hp_alloc_with_preempt += 1
        else:
            self.metrics.hp_alloc_no_preempt += 1
            self.metrics.hp_alloc_latency.add(res.latency)
        dur = hp.config.padded_time * self._jitter()
        dev = self.exec_devices[hp.device]
        actual_start = dev.earliest_start(max(hp.start_time, commit), dur, hp.config.cores)
        actual_end = actual_start + dur
        dev.occupy(actual_start, actual_end, hp.config.cores, hp.task_id)
        if self.obs:
            self.obs.emit(te, "hp_place", priority="HP", device=hp.device,
                          task_id=hp.task_id, frame_id=frame.frame_id,
                          info={"latency": round(res.latency, 6),
                                "preempted": len(res.preempted or ())})
            self.obs.emit(actual_start, "exec", priority="HP",
                          device=hp.device, task_id=hp.task_id,
                          frame_id=frame.frame_id, dur=dur,
                          info={"cores": hp.config.cores})
        self._push(actual_end, "hp_done", (hp, frame, v, actual_end))

    def _on_hp_done(self, t: float, payload) -> None:
        hp, frame, v, actual_end = payload
        self.sched.complete(hp, t)
        if actual_end <= hp.deadline:
            hp.state = TaskState.COMPLETED
            self.metrics.hp_completed += 1
            if self.obs:
                self.obs.emit(t, "hp_done", priority="HP", device=hp.device,
                              task_id=hp.task_id, frame_id=frame.frame_id)
        else:
            hp.state = TaskState.VIOLATED
            self.metrics.hp_violated += 1
            if self.obs:
                self.obs.emit(t, "deadline_miss", priority="HP",
                              device=hp.device, task_id=hp.task_id,
                              frame_id=frame.frame_id,
                              info={"late_by": round(t - hp.deadline, 6)})
            return  # frame already dead; don't spawn LP work
        if v >= 1:
            deadline = frame.release_time + self.cfg.lp_deadline_factor * FRAME_PERIOD
            tasks = [
                Task(
                    Priority.LOW,
                    source_device=frame.device,
                    release_time=t,
                    deadline=deadline,
                    frame_id=frame.frame_id,
                )
                for _ in range(v)
            ]
            frame.lp_tasks.extend(tasks)
            self.metrics.lp_spawned += len(tasks)
            req = LPRequest(tasks, frame.device, t)
            self._push(t, "sched_lp", (req, frame, False))

    def _on_sched_lp(self, t: float, payload) -> None:
        req, frame, is_realloc = payload
        te = self._controller_gate(t)
        if te is None:
            self._push(self.controller_free, "sched_lp", payload)
            return
        res = self.sched.schedule_lp(req, te)
        commit = self._charge_controller(te, res.latency)
        if not res.success:
            for task in req.tasks:
                task.state = TaskState.FAILED
                self.metrics.lp_failed += 1
                if self.obs:
                    self.obs.emit(te, "lp_fail", priority="LP",
                                  device=task.source_device,
                                  task_id=task.task_id,
                                  frame_id=task.frame_id,
                                  info={"realloc": bool(is_realloc)})
            return
        if is_realloc:
            self.metrics.lp_realloc_success += len(req.tasks)
            self.metrics.lp_realloc_latency.add(res.latency)
        else:
            self.metrics.lp_alloc_latency.add(res.latency)
        for task in req.tasks:
            if task.config.cores == 2:
                self.metrics.lp_two_core += 1
            else:
                self.metrics.lp_four_core += 1
            ready = commit
            if task.offloaded:
                self.metrics.lp_offloaded += 1
                comm_start = max(task.comm_window[0], commit)
                comm_start = self.congestion.probe_exit(comm_start)
                comm_end = self.congestion.transfer_end(
                    comm_start, task.transfer_bytes
                )
                self.link_activity.add(comm_start, comm_end)
                ready = comm_end
                if self.obs:
                    self.obs.emit(comm_start, "offload", priority="LP",
                                  device=task.device, task_id=task.task_id,
                                  frame_id=task.frame_id,
                                  dur=comm_end - comm_start,
                                  info={"src": task.source_device,
                                        "bytes": task.transfer_bytes})
            dur = task.config.padded_time * self._jitter()
            dev = self.exec_devices[task.device]
            actual_start = dev.earliest_start(
                max(task.start_time, ready), dur, task.config.cores
            )
            actual_end = actual_start + dur
            dev.occupy(actual_start, actual_end, task.config.cores, task.task_id)
            epoch = getattr(task, "epoch", 0)
            if self.obs:
                self.obs.emit(
                    te, "requeue_place" if is_realloc else "lp_place",
                    priority="LP", device=task.device,
                    task_id=task.task_id, frame_id=task.frame_id,
                    info={"cores": task.config.cores,
                          "offloaded": bool(task.offloaded),
                          "src": task.source_device},
                )
                self.obs.emit(actual_start, "exec", priority="LP",
                              device=task.device, task_id=task.task_id,
                              frame_id=task.frame_id, dur=dur,
                              info={"cores": task.config.cores})
            self._push(actual_end, "task_done", (task, epoch, actual_end))

    def _on_task_done(self, t: float, payload) -> None:
        task, epoch, actual_end = payload
        if getattr(task, "epoch", 0) != epoch or task.state == TaskState.PREEMPTED:
            return  # stale event: the task was preempted/reallocated
        self.sched.complete(task, t)
        # Completion bookkeeping occupies the controller: WPS must bring its
        # exact per-task state back in sync before answering the next query
        # (its O(tasks) removals); RAS's availability windows are already
        # consumed, so completion costs it nothing (SSIV.A.1).
        cost = getattr(self.sched, "completion_cost", 0.0)
        if cost > 0.0:
            start = max(t, self.controller_free)
            self._charge_controller(start, cost)
        if actual_end <= task.deadline:
            task.state = TaskState.COMPLETED
            self.metrics.lp_completed += 1
            if task.realloc_count == 0:
                self.metrics.lp_completed_no_realloc += 1
            if task.offloaded:
                self.metrics.lp_offloaded_completed += 1
            if self.obs:
                self.obs.emit(t, "lp_done", priority="LP",
                              device=task.device, task_id=task.task_id,
                              frame_id=task.frame_id)
        else:
            task.state = TaskState.VIOLATED
            self.metrics.lp_violated += 1
            if self.obs:
                self.obs.emit(t, "deadline_miss", priority="LP",
                              device=task.device, task_id=task.task_id,
                              frame_id=task.frame_id,
                              info={"late_by": round(t - task.deadline, 6)})

    def _on_probe(self, t: float, payload) -> None:
        """Bandwidth estimation round (§V): collided pings read the residual
        bandwidth behind an in-flight image transfer."""
        cfg = self.cfg
        window = max(1.0, min(cfg.bw_interval, 10.0))
        busy = self.link_activity.busy_fraction(t - window, t)
        true_bw = self.congestion.bw(t, exclude_probe=True)
        clean_sample = lambda: true_bw * max(
            0.1, 1.0 + self.rng.normal(0.0, 0.05)
        )
        # Residual wait behind an image transfer ≈ half a transfer at true bw.
        typ_transfer = (
            self.sched.link.transfer_bytes
            if hasattr(self.sched, "link") and hasattr(self.sched.link, "transfer_bytes")
            else 416 * 416 * 3
        )
        residual = 0.5 * typ_transfer * 8.0 / max(true_bw, 1.0)
        ping_bits = PROBE_PING_BYTES * 8.0
        samples = []
        n_targets = cfg.n_devices - 1
        for _ in range(n_targets * PROBE_PING_COUNT):
            if self.rng.random() < busy:
                rtt = ping_bits / max(true_bw, 1.0) + residual
                samples.append(ping_bits / rtt)
            else:
                samples.append(clean_sample())
        prev_est = self.sched.bw.estimate_bps
        self.sched.bandwidth_update(samples, t)
        self.metrics.bw_updates += 1
        if self.obs:
            self.obs.emit(
                t, "bw_update",
                info={"estimate_bps": float(self.sched.bw.estimate_bps),
                      "true_bps": float(true_bw),
                      "busy_fraction": round(busy, 4)},
            )
        if cfg.bw_adaptive:
            # §VII future work: volatile estimates -> probe sooner; stable
            # estimates -> back off (probing itself congests, §VI.B).
            new_est = self.sched.bw.estimate_bps
            shift = abs(new_est - prev_est) / max(prev_est, 1.0)
            if shift > 0.15:
                self._adaptive_interval = max(
                    cfg.bw_adapt_min, self._adaptive_interval / 2.0
                )
            else:
                self._adaptive_interval = min(
                    cfg.bw_adapt_max, self._adaptive_interval * 1.5
                )
            nxt = t + self._adaptive_interval
            if nxt < self.horizon:
                self._push(nxt, "probe", None)
        # Data-structure regeneration stalls the controller (§VI.B).
        rebuild = getattr(self.sched, "last_rebuild_latency", 0.0)
        start = max(t, self.controller_free)
        self._charge_controller(start, rebuild)

    def _jitter(self) -> float:
        """Run-time processing-time jitter (system load, hardware variance;
        §V pads benchmarked times against exactly this)."""
        if self.cfg.proc_jitter <= 0:
            return 1.0
        return max(0.97, 1.0 + float(self.rng.normal(0.0, self.cfg.proc_jitter)))

    def _on_housekeeping(self, t: float, payload) -> None:
        self.link_activity.prune(t - 2 * self.cfg.bw_interval)
        for dev in self.exec_devices:
            dev.prune(t - FRAME_PERIOD)
        if isinstance(self.sched, WPSScheduler):
            self.sched.link = [r for r in self.sched.link if r.end >= t]
        else:
            for dev in self.sched.devices:
                for al in dev.lists.values():
                    al.tracks = [
                        [w for w in track if w.t2 > t] for track in al.tracks
                    ]
                dev.prune(t)


def run_experiment(cfg: ExperimentConfig,
                   event_log: Optional[EventLog] = None) -> Metrics:
    return Simulation(cfg, event_log=event_log).run()
