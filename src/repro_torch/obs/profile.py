"""Host-side phase profiling: a lightweight span timer plus an optional
``torch.profiler`` hook.

Counterpart of ``repro/obs/profile.py``: ``PhaseTimer`` and ``span`` are
the reference's; ``maybe_jax_trace`` becomes ``maybe_torch_trace``.

- **Span timer** — ``with PhaseTimer() as t:`` activates collection;
  instrumented code (``fleet_run`` segments, benchmark scripts) wraps its
  phases in ``with span("name"):``.  When no timer is active a span is a
  no-op (one list check), so the engine can stay instrumented
  unconditionally.  ``t.summary()`` reduces to per-phase count / total /
  mean / max, and ``t.save(path)`` persists the summary as a
  ``results/obs/`` artifact.
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
import json
import os
import time
from typing import Iterator

import torch

ENV_VAR = "REPRO_PROFILE_DIR"

#: currently-active timers (appended by ``PhaseTimer.__enter__``).
_ACTIVE: list["PhaseTimer"] = []

_TRACING = False


class PhaseTimer:
    """Collects wall-clock span durations while active (context manager)."""

    def __init__(self) -> None:
        self.spans: dict[str, list[float]] = {}

    def add(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def __enter__(self) -> "PhaseTimer":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)

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
        """Write ``{phases: summary, **extra}`` as JSON; returns the dict."""
        payload = {"phases": self.summary()}
        if extra:
            payload.update(extra)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return payload


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Record a wall-clock span into every active PhaseTimer (no-op when
    none is active)."""
    if not _ACTIVE:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        for timer in _ACTIVE:
            timer.add(name, dt)


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
