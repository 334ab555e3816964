"""Experiment metrics (§VI): frame completion, latency breakdowns by
scenario, deadline violations, offload performance, core-allocation split."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Optional

from repro_torch.core.tasks import Frame, Task, TaskState


@dataclasses.dataclass
class LatencyStats:
    samples: list[float] = dataclasses.field(default_factory=list)

    def add(self, v: float) -> None:
        self.samples.append(v)

    @property
    def mean(self) -> float:
        return statistics.fmean(self.samples) if self.samples else 0.0

    @property
    def p99(self) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        return s[min(len(s) - 1, int(0.99 * len(s)))]

    def __len__(self) -> int:
        return len(self.samples)


@dataclasses.dataclass
class Metrics:
    # frames
    frames_total: int = 0
    frames_completed: int = 0
    # HP tasks
    hp_alloc_no_preempt: int = 0
    hp_alloc_with_preempt: int = 0
    hp_failed: int = 0
    hp_completed: int = 0
    hp_violated: int = 0
    # LP tasks
    lp_spawned: int = 0
    lp_completed: int = 0
    lp_violated: int = 0
    lp_failed: int = 0
    lp_preempted: int = 0
    lp_realloc_success: int = 0
    lp_completed_no_realloc: int = 0
    # offloading
    lp_offloaded: int = 0
    lp_offloaded_completed: int = 0
    # core split of successfully allocated LP tasks
    lp_two_core: int = 0
    lp_four_core: int = 0
    # latency by scenario (§VI.A / Fig. 5)
    hp_alloc_latency: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    hp_preempt_latency: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    lp_alloc_latency: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    lp_realloc_latency: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    # controller
    controller_busy_time: float = 0.0
    bw_updates: int = 0

    @property
    def frame_completion_rate(self) -> float:
        return self.frames_completed / self.frames_total if self.frames_total else 0.0

    @property
    def four_core_fraction(self) -> float:
        alloc = self.lp_two_core + self.lp_four_core
        return self.lp_four_core / alloc if alloc else 0.0

    def finalize_frames(self, frames: list[Frame]) -> None:
        self.frames_total = len(frames)
        self.frames_completed = sum(1 for f in frames if f.completed)

    def calib_view(self) -> dict:
        """Counters normalised for the fleet-vs-serial calibration harness
        (calib/): every key has a direct fleet analog (see
        ``repro_torch.calib.harness.fleet_view``), with preemption accounting
        aligned on *committed* preemptions — ``lp_preempted`` here counts
        actually-evicted victims, exactly what the fleet engine's
        ``hp_preempted`` counts.

        ``lp_placed_rate`` folds deadline-violated tasks back in: the
        fleet abstraction has no run-time jitter, so its completions
        correspond to the serial engine's *placements in time* rather
        than its jitter-surviving completions.
        """
        frames = max(self.frames_total, 1)
        lp = max(self.lp_spawned, 1)
        return {
            "frames": self.frames_total,
            "frame_completion_rate": self.frame_completion_rate,
            "hp_completion_rate": self.hp_completed / frames,
            "hp_failure_rate": self.hp_failed / frames,
            "preemption_rate": self.lp_preempted / frames,
            "lp_completion_rate": self.lp_completed / lp,
            "lp_placed_rate": (self.lp_completed + self.lp_violated) / lp,
            "four_core_fraction": self.four_core_fraction,
            "lp_spawned": self.lp_spawned,
            "lp_completed": self.lp_completed,
            "preemptions": self.lp_preempted,
            "realloc_success": self.lp_realloc_success,
        }

    def summary(self) -> dict:
        return {
            "frame_completion_rate": round(self.frame_completion_rate, 4),
            "frames": f"{self.frames_completed}/{self.frames_total}",
            "hp_no_preempt": self.hp_alloc_no_preempt,
            "hp_with_preempt": self.hp_alloc_with_preempt,
            "hp_failed": self.hp_failed,
            "lp_completed": self.lp_completed,
            "lp_completed_no_realloc": self.lp_completed_no_realloc,
            "lp_violated": self.lp_violated,
            "lp_failed": self.lp_failed,
            "lp_realloc_success": self.lp_realloc_success,
            "lp_offloaded_completed": self.lp_offloaded_completed,
            "lp_offloaded": self.lp_offloaded,
            "hp_alloc_ms": round(1e3 * self.hp_alloc_latency.mean, 3),
            "hp_preempt_ms": round(1e3 * self.hp_preempt_latency.mean, 3),
            "lp_alloc_ms": round(1e3 * self.lp_alloc_latency.mean, 3),
            "lp_realloc_ms": round(1e3 * self.lp_realloc_latency.mean, 3),
            "four_core_frac": round(self.four_core_fraction, 4),
            "controller_busy_s": round(self.controller_busy_time, 3),
        }
