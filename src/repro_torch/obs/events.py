"""Structured event log for the serial DES engine (sim/engine.py).

An ``EventLog`` is handed to ``Simulation``/``run_experiment``; the engine
emits one typed ``Event`` per scheduling decision with its sim-timestamp,
device, task id and priority.  The vocabulary (``KINDS``) covers the
paper's §VI mechanisms end to end:

    frame_release   a conveyor-belt frame arrives on a device
    hp_place        HP task admitted (start, latency, #victims in info)
    hp_admit_fail   HP containment miss with nothing preemptable
    preempt         a committed LP victim is evicted (one per victim)
    requeue_place   an evicted victim re-placed via the §VI.A realloc path
    lp_place        LP task placed (cores / offload target in info)
    lp_fail         LP placement infeasible everywhere — task failed
    offload         image transfer occupying the shared link (duration)
    exec            a task's execution interval on its device (duration)
    hp_done/lp_done task finished within its deadline
    deadline_miss   task finished late (priority says which class)
    bw_update       a probe round updated the bandwidth EMA (estimate_bps)

Events are plain frozen dataclasses; ``to_jsonl``/``from_jsonl`` give the
compact line-oriented interchange format, and ``obs/export.py`` renders a
log as a Chrome trace-event / Perfetto timeline.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator

KINDS = (
    "frame_release",
    "hp_place",
    "hp_admit_fail",
    "preempt",
    "requeue_place",
    "lp_place",
    "lp_fail",
    "offload",
    "exec",
    "hp_done",
    "lp_done",
    "deadline_miss",
    "bw_update",
)


@dataclasses.dataclass(frozen=True)
class Event:
    t: float                 # sim-time (s) the event takes effect
    kind: str                # one of KINDS
    device: int = -1         # device the event acts on (-1: none/link)
    task_id: int = -1
    frame_id: int = -1
    priority: str = ""       # "HP" | "LP" | ""
    dur: float = 0.0         # span length (s) for exec/offload, else 0
    info: dict = dataclasses.field(default_factory=dict)


class EventLog:
    """Append-only in-memory event collection with JSONL (de)serialise."""

    def __init__(self) -> None:
        self.events: list[Event] = []

    def emit(self, t: float, kind: str, **kw) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown event kind {kind!r}; known: {KINDS}")
        self.events.append(Event(t=float(t), kind=kind, **kw))

    def __len__(self) -> int:
        return len(self.events)

    def __bool__(self) -> bool:
        # an *empty* log must still be truthy: the engines guard emit
        # sites with ``if self.obs:`` and the log starts empty
        return True

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(dataclasses.asdict(e)) + "\n")

    @staticmethod
    def from_jsonl(path: str) -> "EventLog":
        log = EventLog()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    log.events.append(Event(**json.loads(line)))
        return log
