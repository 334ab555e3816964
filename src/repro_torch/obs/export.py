"""Exporters: fleet telemetry / serial event logs → Chrome trace-event
JSON (loads in ui.perfetto.dev or chrome://tracing).

The Chrome trace-event format is a JSON object ``{"traceEvents": [...]}``
whose entries carry ``ph`` (phase), ``ts`` (microseconds), ``pid``/
``tid`` (track grouping), ``name`` and ``args``.  We use:

    ph "M"  metadata        process_name / thread_name track labels
    ph "X"  complete span   task executions and link transfers (serial)
    ph "i"  instant         preemptions, admission failures, releases
    ph "C"  counter         re-queue depth, bandwidth, per-device free
                            capacity — Perfetto renders these as stacked
                            counter tracks

Track layout:

- **fleet** (``fleet_trace_events``): one Perfetto *process* per replica
  (``pid = replica``), one *thread* per device (``tid = device``) holding
  that device's instant events, plus per-replica counter tracks
  (``rq_depth``, ``bandwidth_mbps``, ``link_backlog_s``,
  ``dev{d}_free_time_s``, ``dev{d}_free_windows``).
- **serial** (``sim_trace_events``): one process, one thread per device
  with ``X`` spans for every execution interval, a ``link`` thread for
  transfers, and a ``bw_estimate_mbps`` counter from probe rounds (the
  bandwidth-EMA trajectory of §VI.B).

``validate_trace`` structurally checks an exported object against the
subset of the spec we emit — the CI smoke leg gates on it.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.obs.events import Event
from repro_torch.obs.telemetry import TelemetryRecord

_US = 1e6  # trace-event timestamps are microseconds

_VALID_PH = {"M", "X", "i", "I", "C", "b", "e"}


def _proc_meta(pid: int, name: str) -> dict:
    return {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": name}}


def _thread_meta(pid: int, tid: int, name: str) -> dict:
    return {"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
            "args": {"name": name}}


def _counter(pid: int, name: str, ts: float, value: float) -> dict:
    return {"ph": "C", "pid": pid, "tid": 0, "name": name, "ts": ts,
            "args": {"value": round(float(value), 4)}}


def _instant(pid: int, tid: int, name: str, ts: float,
             args: Optional[dict] = None) -> dict:
    return {"ph": "i", "pid": pid, "tid": tid, "name": name, "ts": ts,
            "s": "t", "args": args or {}}


def _span(pid: int, tid: int, name: str, ts: float, dur: float,
          args: Optional[dict] = None) -> dict:
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts,
            "dur": max(dur, 0.0), "args": args or {}}


# ---------------------------------------------------------------------------
# fleet telemetry → trace events
# ---------------------------------------------------------------------------

def fleet_trace_events(rec: TelemetryRecord,
                       replicas: Optional[Sequence[int]] = None,
                       max_replicas: int = 4) -> list[dict]:
    """Render a TelemetryRecord as trace events (default: the first
    ``max_replicas`` replicas; pass ``replicas`` to pick explicitly)."""
    s = rec.series
    B, dev = rec.n_replicas, rec.n_devices
    reps = list(replicas) if replicas is not None else \
        list(range(min(B, max_replicas)))
    bad = [r for r in reps if not 0 <= r < B]
    if bad:
        raise ValueError(f"replica indices {bad} out of range [0, {B})")

    ev: list[dict] = []
    for r in reps:
        ev.append(_proc_meta(r, f"fleet replica {r}"))
        for d in range(dev):
            ev.append(_thread_meta(r, d, f"dev{d}"))

    times = rec.times()
    for i, t in enumerate(times):
        ts = t * _US
        for r in reps:
            ev.append(_counter(r, "rq_depth", ts, s.rq_depth[i, r]))
            ev.append(_counter(r, "bandwidth_mbps", ts,
                               s.bandwidth_bps[i, r] / 1e6))
            # link backlog: seconds the shared-link FIFO head sits past now
            ev.append(_counter(r, "link_backlog_s", ts,
                               max(float(s.link_free[i, r]) - t, 0.0)))
            for d in range(dev):
                ev.append(_counter(r, f"dev{d}_free_time_s", ts,
                                   s.free_time[i, r, d]))
                ev.append(_counter(r, f"dev{d}_free_windows", ts,
                                   s.free_windows[i, r, d]))
                if s.hp_run_dev[i, r, d]:
                    ev.append(_instant(r, d, "hp_frame", ts,
                                       {"count": int(s.hp_run_dev[i, r, d])}))
                if s.lp_placed_dev[i, r, d]:
                    ev.append(_instant(
                        r, d, "lp_place", ts,
                        {"count": int(s.lp_placed_dev[i, r, d])}))
                if s.preempt_dev[i, r, d]:
                    ev.append(_instant(
                        r, d, "preempt", ts,
                        {"count": int(s.preempt_dev[i, r, d])}))
                if s.hp_fail_dev[i, r, d]:
                    ev.append(_instant(
                        r, d, "hp_admit_fail", ts,
                        {"count": int(s.hp_fail_dev[i, r, d])}))
            if s.missed_by_preemption_d[i, r]:
                ev.append(_instant(
                    r, 0, "deadline_miss", ts,
                    {"count": int(s.missed_by_preemption_d[i, r])}))
    return ev


# ---------------------------------------------------------------------------
# serial event log → trace events
# ---------------------------------------------------------------------------

#: event kinds rendered as instants on the device thread.
_SIM_INSTANTS = {"frame_release", "preempt", "hp_admit_fail", "lp_fail",
                 "deadline_miss", "requeue_place", "hp_place", "lp_place",
                 "hp_done", "lp_done"}


def sim_trace_events(events: Iterable[Event], pid: int = 0) -> list[dict]:
    """Render a serial-DES event log as trace events: execution spans per
    device thread, transfers on a link thread, instants for scheduling
    decisions, and a counter track for the bandwidth-EMA estimate."""
    events = list(events)
    max_dev = max((e.device for e in events if e.device >= 0), default=-1)
    link_tid = max_dev + 1

    ev: list[dict] = [_proc_meta(pid, "serial DES")]
    for d in range(max_dev + 1):
        ev.append(_thread_meta(pid, d, f"dev{d}"))
    ev.append(_thread_meta(pid, link_tid, "link"))

    for e in events:
        ts = e.t * _US
        if e.kind == "exec":
            name = f"{e.priority or 'task'} {e.task_id}"
            ev.append(_span(pid, max(e.device, 0), name, ts, e.dur * _US,
                            {"task_id": e.task_id, **e.info}))
        elif e.kind == "offload":
            ev.append(_span(pid, link_tid, f"transfer {e.task_id}", ts,
                            e.dur * _US, {"task_id": e.task_id, **e.info}))
        elif e.kind == "bw_update":
            est = e.info.get("estimate_bps")
            if est is not None:
                ev.append(_counter(pid, "bw_estimate_mbps", ts, est / 1e6))
        elif e.kind in _SIM_INSTANTS:
            tid = e.device if e.device >= 0 else 0
            args = {"task_id": e.task_id, "priority": e.priority, **e.info}
            ev.append(_instant(pid, tid, e.kind, ts, args))
    return ev


# ---------------------------------------------------------------------------
# serialisation + validation
# ---------------------------------------------------------------------------

def write_chrome_trace(path: str, events: list[dict]) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def validate_trace(obj) -> list[str]:
    """Structural check of a Chrome trace-event object; returns a list of
    violations (empty = valid).  Covers the subset of the spec the
    exporters emit, which is what ui.perfetto.dev needs to render."""
    errors: list[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' array"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' must be an array"]
    if not evs:
        errors.append("'traceEvents' is empty")
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _VALID_PH:
            errors.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            errors.append(f"{where}: missing name")
        if not isinstance(e.get("pid"), int):
            errors.append(f"{where}: missing integer pid")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0 or not np.isfinite(ts):
            errors.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X event needs dur >= 0")
        if ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args or not all(
                isinstance(v, (int, float)) and np.isfinite(v)
                for v in args.values()
            ):
                errors.append(f"{where}: C event needs finite numeric args")
        if ph == "i" and e.get("s") not in (None, "t", "p", "g"):
            errors.append(f"{where}: bad instant scope {e.get('s')!r}")
        if len(errors) > 20:
            errors.append("... (truncated)")
            break
    return errors


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
