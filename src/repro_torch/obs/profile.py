"""Phase profiling: a span timer with device time and counters, plus an
optional ``torch.profiler`` hook.

Counterpart of ``repro/obs/profile.py``: ``PhaseTimer`` and ``span`` are
the reference's; ``maybe_jax_trace`` becomes ``maybe_torch_trace``.

- **Span timer** — ``with PhaseTimer() as t:`` activates collection;
  instrumented code (``fleet_run``'s segments and ticks, benchmark
  scripts) wraps its phases in ``with span("name"):``. When no timer is
  active a span is a no-op (one list check), so the engine can stay
  instrumented unconditionally. Each span exit calls ``t.add(name,
  seconds)``; ``t.summary()`` reduces those to per-phase count / total /
  mean / max, and ``t.save(path)`` writes the summary, the span records
  and the counters as a ``results/obs/`` artifact.
- **Span records** — an active timer also keeps one record a span, in
  memory: its name, its host start and end in ``time.time_ns()`` (the
  clock of the profiler's host events, so a record joins a trace), the
  index of the span that encloses it (``parent``), the identifier of the
  unit of work it belongs to (``trace``: ``fleet_run`` gives each tick
  ``(run, tick)``, which the spans inside it inherit) and its torch
  device (inherited too). ``t.phases()`` gives each name's total and
  self time (a span less its children).
- **Device time** — ``PhaseTimer(device_time=True)`` also records a
  ``torch.cuda.Event`` on the current stream at each entry and exit of a
  span on a CUDA device, from a pool, without synchronizing; the caller
  synchronizes, and ``t.resolve()`` (called by ``records``, ``phases``
  and ``save``) turns the pairs into ``device_ms``. Elsewhere
  ``device_ms`` is None.
- **Counters** — under a device-timed timer, ``counter(name, shape,
  device)`` hands instrumented code an int64 buffer on the device to add
  to (``fused_place``'s rows attempted and committed, per attempt slot);
  ``t.counters()`` sums each name's buffers once the run has
  synchronized. With no such timer it returns None and nothing counts.
- **The profiler's stream** — while a ``torch.profiler`` session is on,
  each span is also a host ``cpu_op`` of its name in the trace, never a
  user annotation, so no device-side event carries a span's name. It
  closes before the timers are told of the exit.
- **Device profiler hook** — ``maybe_torch_trace()`` wraps a block in a
  ``torch.profiler.profile`` (CPU activity, and CUDA where a card is
  present) when ``REPRO_PROFILE_DIR`` is set, and writes the block's Chrome
  trace there (``<host>_<pid>.<ms>.pt.trace.json``; it opens in
  ui.perfetto.dev or TensorBoard's profiler); it is a no-op otherwise.
  Only the outermost block traces, and a block inside another
  ``torch.profiler`` session (a caller profiling the run itself) passes
  through too: the profiler cannot run two sessions at once.

Timers nest: every active timer records every span, so a benchmark-level
timer sees the engine's internal phases too.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Iterator

import torch

try:  # a host cpu_op in a profiler session, with no device-side twin
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # pragma: no cover - older torch: spans stay off it
    _RecordFunctionFast = None

ENV_VAR = "REPRO_PROFILE_DIR"

#: currently-active timers (appended by ``PhaseTimer.__enter__``).
_ACTIVE: list["PhaseTimer"] = []

_TRACING = False

_NULL = contextlib.nullcontext()

#: identifiers of units of work (``fleet_run`` takes one a call)
_RUN_IDS = itertools.count()


def next_run_id() -> int:
    """A fresh identifier for the spans of one unit of work."""
    return next(_RUN_IDS)


class _Record:
    """One span as a timer keeps it."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "trace", "device",
                 "events", "device_ms")

    def __init__(self, name, start_ns, parent, trace, device):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = None
        self.parent = parent
        self.trace = trace
        self.device = device
        self.events = None
        self.device_ms = None

    def as_dict(self) -> dict:
        return {"name": self.name, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "parent": self.parent,
                "trace": None if self.trace is None else list(self.trace),
                "device": None if self.device is None else str(self.device),
                "device_ms": self.device_ms}


class PhaseTimer:
    """Collects span durations and records while active (context
    manager); with ``device_time`` each span on a CUDA device is also
    timed on its stream, and counters are kept."""

    def __init__(self, device_time: bool = False) -> None:
        self.spans: dict[str, list[float]] = {}
        self.device_time = device_time
        self._records: list[_Record] = []
        self._open: list[int] = []
        self._pool: list = []
        self._buffers: dict[str, list[torch.Tensor]] = {}

    def add(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def __enter__(self) -> "PhaseTimer":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)

    # -- spans -------------------------------------------------------------
    def _enter(self, name, t0, trace, device) -> int:
        parent = self._open[-1] if self._open else None
        if parent is not None:
            up = self._records[parent]
            trace = up.trace if trace is None else trace
            device = up.device if device is None else device
        rec = _Record(name, t0, parent, trace, device)
        if (self.device_time and device is not None
                and torch.device(device).type == "cuda"):
            rec.events = (self._event(), self._event())
            rec.events[0].record(torch.cuda.current_stream(device))
        i = len(self._records)
        self._records.append(rec)
        self._open.append(i)
        return i

    def _exit_device(self, i: int) -> None:
        rec = self._records[i]
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(rec.device))

    def _exit(self, i: int, t1: int) -> None:
        rec = self._records[i]
        rec.end_ns = t1
        self._open.remove(i)
        self.add(rec.name, (t1 - rec.start_ns) / 1e9)

    def _event(self):
        return (self._pool.pop() if self._pool
                else torch.cuda.Event(enable_timing=True))

    def resolve(self) -> None:
        """Turn every closed span's event pair into ``device_ms`` and
        return the events to the pool. Call once the spans' work has
        finished on the device (after a synchronize)."""
        for rec in self._records:
            if rec.events is not None and rec.end_ns is not None:
                start, end = rec.events
                rec.device_ms = start.elapsed_time(end)
                rec.events = None
                self._pool += (start, end)

    def records(self) -> list[dict]:
        """Every span recorded so far, in entry order, as dicts."""
        self.resolve()
        return [r.as_dict() for r in self._records]

    def phases(self) -> dict:
        """Per span name: count, host ms in all and of its own (less its
        children's), and the same on the device (None without device
        time)."""
        self.resolve()
        recs = self._records
        child_host = [0] * len(recs)
        child_dev = [0.0] * len(recs)
        for r in recs:
            if r.parent is not None and r.end_ns is not None:
                child_host[r.parent] += r.end_ns - r.start_ns
                if r.device_ms is not None:
                    child_dev[r.parent] += r.device_ms
        out: dict[str, dict] = {}
        for i, r in enumerate(recs):
            if r.end_ns is None:
                continue
            row = out.setdefault(r.name, {
                "count": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                "device_ms": None, "self_device_ms": None})
            host = (r.end_ns - r.start_ns) / 1e6
            row["count"] += 1
            row["host_ms"] += host
            row["self_host_ms"] += host - child_host[i] / 1e6
            if r.device_ms is not None:
                row["device_ms"] = (row["device_ms"] or 0.0) + r.device_ms
                row["self_device_ms"] = ((row["self_device_ms"] or 0.0)
                                         + r.device_ms - child_dev[i])
        return out

    # -- counters ----------------------------------------------------------
    def counters(self) -> dict[str, list]:
        """Each counter's buffers summed, as nested lists (read once the
        run has synchronized)."""
        out = {}
        for name, bufs in self._buffers.items():
            total = bufs[0].cpu().clone()
            for b in bufs[1:]:
                total += b.cpu()
            out[name] = total.tolist()
        return out

    def summary(self) -> dict:
        out = {}
        for name, xs in sorted(self.spans.items()):
            total = sum(xs)
            out[name] = {
                "count": len(xs),
                "total_s": round(total, 6),
                "mean_ms": round(total / len(xs) * 1e3, 3),
                "max_ms": round(max(xs) * 1e3, 3),
            }
        return out

    def save(self, path: str, extra: dict | None = None) -> dict:
        """Write ``{phases: summary, spans: records, counters, **extra}``
        as JSON; returns the dict."""
        payload = {"phases": self.summary(), "spans": self.records(),
                   "counters": self.counters()}
        if extra:
            payload.update(extra)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return payload


class _Span:
    """An active span: entered in every active timer, and in the
    profiler's stream while a session is on."""

    __slots__ = ("name", "trace", "device", "_timers", "_rf")

    def __init__(self, name, trace, device):
        self.name, self.trace, self.device = name, trace, device

    def __enter__(self):
        self._rf = None
        if (_RecordFunctionFast is not None
                and torch._C._autograd._profiler_enabled()):
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        t0 = time.time_ns()
        self._timers = [(t, t._enter(self.name, t0, self.trace, self.device))
                        for t in _ACTIVE]
        return self

    def __exit__(self, *exc):
        for t, i in self._timers:
            t._exit_device(i)
        t1 = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        for t, i in self._timers:
            t._exit(i, t1)


def span(name: str, *, trace=None, device=None):
    """A span of ``name`` in every active PhaseTimer (a no-op when none
    is active). ``trace`` names the unit of work and ``device`` the torch
    device it runs on; a span given neither takes its parent's."""
    if not _ACTIVE:
        return _NULL
    return _Span(name, trace, device)


def counter(name: str, shape, device) -> torch.Tensor | None:
    """A zeroed int64 buffer of ``shape`` on ``device`` that every active
    device-timed timer sums into its counter ``name``; None where no
    timer is device-timed."""
    timers = [t for t in _ACTIVE if t.device_time]
    if not timers:
        return None
    buf = torch.zeros(shape, dtype=torch.int64, device=device)
    for t in timers:
        t._buffers.setdefault(name, []).append(buf)
    return buf


@contextlib.contextmanager
def maybe_torch_trace() -> Iterator[None]:
    """Wrap a block in ``torch.profiler.profile`` and write its Chrome
    trace under ``$REPRO_PROFILE_DIR`` when the variable is set; plain
    passthrough otherwise, when nested, and when another torch profiler
    session is already on."""
    global _TRACING
    trace_dir = os.environ.get(ENV_VAR, "")
    if not trace_dir or _TRACING or torch._C._autograd._profiler_enabled():
        yield
        return
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _TRACING = True
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(trace_dir)):
            yield
    finally:
        _TRACING = False
