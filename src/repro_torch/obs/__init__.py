"""Observability subsystem: in-loop fleet telemetry, serial-DES event
logs, Chrome-trace/Perfetto exporters, and host-side phase profiling.

Counterpart of ``repro/obs``: ``events.py`` and ``export.py`` are copies,
``telemetry.py`` captures the reference's series with torch ops on the
fleet's device, and ``profile.py``'s device hook is ``maybe_torch_trace``
(a ``torch.profiler`` trace under ``REPRO_PROFILE_DIR``).

``profile.py``'s ``PhaseTimer`` keeps a tree of spans: ``fleet_run``'s
segments, each tick (traced ``(run, tick)``) and the tick's phases
(compaction, re-queue, HP, LP), each with its parent, its device and its
host start and end in ``time.time_ns()``, the clock of the profiler's
host events. ``PhaseTimer(device_time=True)`` also times each span on
the card by CUDA events, resolved after the caller synchronizes, and
collects counters (``profile.counter``), such as ``fused_place``'s rows
attempted and committed per attempt slot, counted inside the kernel.

Deliberately dependency-light at import time: this package is imported
by ``fleet/engine.py`` and ``sim/engine.py``, so nothing here may import
them back at module scope (the CLI imports the engines lazily).
"""

from repro_torch.obs.events import KINDS, Event, EventLog
from repro_torch.obs.export import (
    fleet_trace_events,
    load_trace,
    sim_trace_events,
    validate_trace,
    write_chrome_trace,
)
from repro_torch.obs.profile import PhaseTimer, maybe_torch_trace, span
from repro_torch.obs.telemetry import (
    TelemetryFrame,
    TelemetryRecord,
    assemble,
    capture_tick,
    load_record,
)

__all__ = [
    "Event",
    "EventLog",
    "KINDS",
    "PhaseTimer",
    "TelemetryFrame",
    "TelemetryRecord",
    "assemble",
    "capture_tick",
    "fleet_trace_events",
    "load_record",
    "load_trace",
    "maybe_torch_trace",
    "sim_trace_events",
    "span",
    "validate_trace",
    "write_chrome_trace",
]
