"""Task, request and frame abstractions for the offloading scheduler.

Mirrors the paper's §III/§V task model:

- A *frame* is produced by an edge device every ``FRAME_PERIOD`` seconds
  (conveyor-belt sampling).  Stage 1 (object detection) is a **high-priority
  (HP)** task that must run on its source device.  If waste is detected,
  stage 2/3 spawn a **low-priority (LP) request** carrying 1..4 DNN tasks
  that may be offloaded anywhere in the network.
- LP tasks run in one of two *configurations*: a slow two-core one or a fast
  four-core one.  The scheduler prefers two cores and only widens to four
  when the deadline would otherwise be violated (§IV.B.2).
- Every configuration has a fixed, benchmarked processing time (§V), padded
  by the benchmark's standard deviation.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Optional

# ----------------------------------------------------------------------------
# Paper constants (§V Implementation)
# ----------------------------------------------------------------------------

#: Seconds between consecutive frames on each conveyor-belt device.
FRAME_PERIOD = 18.86

#: Benchmarked fixed processing times (seconds).
HP_PROC_TIME = 0.98
LP2_PROC_TIME = 16.862
LP4_PROC_TIME = 11.611

#: Std-dev padding applied to LP processing times (§V "we use the standard
#: deviation from benchmark tests as padding").  The paper does not publish
#: the raw std-devs; we use 2% of the mean, which keeps the published totals.
LP_PAD_FRACTION = 0.02

#: Cores per edge device (Raspberry Pi 2B).
DEVICE_CORES = 4

#: Probe traffic model (§V): 10 pings of 1400 bytes per target device.
PROBE_PING_BYTES = 1400
PROBE_PING_COUNT = 10

#: EWMA smoothing for the bandwidth estimate.
BANDWIDTH_EWMA_ALPHA = 0.3

#: Maximum image transfer: the paper sizes the link's base unit ``D`` from
#: the largest classifier input.  YoloV2-style 416x416x3 uint8 ~ 519 KB.
MAX_IMAGE_BYTES = 416 * 416 * 3


class Priority(enum.IntEnum):
    HIGH = 0
    LOW = 1


class TaskState(enum.Enum):
    PENDING = "pending"
    ALLOCATED = "allocated"
    RUNNING = "running"
    COMPLETED = "completed"
    PREEMPTED = "preempted"
    VIOLATED = "violated"  # missed its deadline
    FAILED = "failed"      # could not be allocated at all


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """An application configuration (§IV.A.1): cores + fixed duration."""

    name: str
    cores: int
    proc_time: float

    @property
    def padded_time(self) -> float:
        if self.name == "hp":
            return self.proc_time
        return self.proc_time * (1.0 + LP_PAD_FRACTION)


#: Stage-1 object detection runs two-threaded (0.98 s YoloV2-lite pass on an
#: RPi 2B).  Two cores keeps the paper's single-victim preemption sufficient:
#: evicting one LP task (≥ 2 cores) always frees enough for the detector.
HP_CONFIG = TaskConfig("hp", cores=2, proc_time=HP_PROC_TIME)
LP2_CONFIG = TaskConfig("lp2", cores=2, proc_time=LP2_PROC_TIME)
LP4_CONFIG = TaskConfig("lp4", cores=4, proc_time=LP4_PROC_TIME)

#: Every availability list a device must maintain (§IV.A.1: "each device must
#: maintain an individual resource availability list for each application
#: configuration").
ALL_CONFIGS = (HP_CONFIG, LP2_CONFIG, LP4_CONFIG)

_task_ids = itertools.count()


def reset_task_ids() -> None:
    global _task_ids
    _task_ids = itertools.count()


@dataclasses.dataclass
class Task:
    """A single schedulable unit of work."""

    priority: Priority
    source_device: int
    release_time: float
    deadline: float
    frame_id: int
    #: Bytes that must cross the network link if the task is offloaded.
    transfer_bytes: int = MAX_IMAGE_BYTES
    task_id: int = dataclasses.field(default_factory=lambda: next(_task_ids))

    # -- filled in by the scheduler --------------------------------------
    config: Optional[TaskConfig] = None
    device: Optional[int] = None
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    comm_window: Optional[tuple[float, float]] = None
    state: TaskState = TaskState.PENDING
    #: Scheduling latency actually incurred, split by scenario (§VI.A).
    alloc_latency: float = 0.0
    realloc_count: int = 0

    @property
    def offloaded(self) -> bool:
        return self.device is not None and self.device != self.source_device

    def interval(self) -> tuple[float, float]:
        assert self.start_time is not None and self.end_time is not None
        return (self.start_time, self.end_time)

    def overlaps(self, t1: float, t2: float) -> bool:
        if self.start_time is None or self.end_time is None:
            return False
        return self.start_time < t2 and t1 < self.end_time


@dataclasses.dataclass
class LPRequest:
    """A low-priority DNN scheduling request: n tasks allocated atomically."""

    tasks: list[Task]
    source_device: int
    release_time: float

    def __len__(self) -> int:
        return len(self.tasks)


@dataclasses.dataclass
class Frame:
    """One conveyor-belt frame.  Completed iff its HP task and *all* spawned
    LP tasks complete before their deadlines (§VI.A)."""

    frame_id: int
    device: int
    release_time: float
    hp_task: Optional[Task] = None
    lp_tasks: list[Task] = dataclasses.field(default_factory=list)

    @property
    def completed(self) -> bool:
        if self.hp_task is None:  # -1 entry: nothing to do => vacuously done
            return True
        if self.hp_task.state != TaskState.COMPLETED:
            return False
        return all(t.state == TaskState.COMPLETED for t in self.lp_tasks)
