"""The program's own spans and counters (``repro_torch/obs/profile.py``)
joined to the traced slice on the profiler's clock.

A span record carries its host start and end in ``time.time_ns()``, the
clock of the profiler's host events, so it lines up with the slice's
runtime calls and device intervals (``trace.py``). Three joins:

- the host's time to issue a tick: each slice tick's ``fleet/tick`` host
  duration less, for every runtime call inside it, its excess over the
  median runtime call of the slice. A call that takes longer than the
  median waits, in the main for room in the launch queue where the card
  paces, so what is left is the host's own work;
- each idle gap of the card (between merged device intervals) put down to
  the innermost span whose host interval covers its midpoint, or to
  ``OUTSIDE``;
- per phase, the device and host time of its spans in the slice.

``intervals`` takes the slice's runtime calls and device intervals from
the profiler's events; every other function takes the readers' context
of a run traced by ``drivers/fleet_sweep_spans.py`` and returns None
where the program kept no spans (a program without them). No cell reads
them yet: a per-layer reader of any of them is a few lines over these.
"""

from __future__ import annotations

import bisect
import re
import statistics

from chipbench.trace import _merged

TICK = "fleet/tick"
COUNTER = "fleet/fused_place"
OUTSIDE = "outside any span"
#: host calls into the CUDA runtime or driver API
_RUNTIME = re.compile(r"cu(da)?[A-Z]")


def intervals(events) -> dict:
    """The slice's host runtime calls (``runtime_calls``) and the union
    of its device operations (``device_intervals``), each a sorted list
    of ``[start, end]`` ns, from the profiler's raw events."""
    from torch.autograd import DeviceType

    calls, dev = [], []
    for e in events:
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((a, b))
        elif b > a and _RUNTIME.match(e.name()):
            calls.append([a, b])
    calls.sort()
    return {"runtime_calls": calls, "device_intervals": _merged(dev)}


def _slice_indices(ctx) -> list:
    """Indices into ``ctx["spans"]`` of the slice's ticks' records: each
    tick's ``fleet/tick`` and every span inside it."""
    if not ctx or not ctx.get("spans") or "slice" not in ctx:
        return []
    first = ctx["slice"]["first_tick"]
    end = first + ctx["slice"]["ticks"]
    return [i for i, r in enumerate(ctx["spans"]) if r["trace"] is not None
            and first <= r["trace"][1] < end]


def slice_records(ctx):
    """The span records of the slice's ticks, or None."""
    return [ctx["spans"][i] for i in _slice_indices(ctx)] or None


def device_ms(ctx, name: str):
    """``(total device ms, count)`` of the slice's spans of ``name``, or
    None where the spans carry no device time."""
    recs = slice_records(ctx)
    if recs is None:
        return None
    times = [r["device_ms"] for r in recs if r["name"] == name]
    if not times or any(t is None for t in times):
        return None
    return sum(times), len(times)


def device_ms_per_tick(ctx, name: str):
    """Device ms of the slice's ``name`` spans over the slice's ticks."""
    got = device_ms(ctx, name)
    if got is None:
        return None
    return got[0] / ctx["slice"]["ticks"]


def issue_ms(ticks, runtime_calls) -> list:
    """Each tick's host ms less the excess of every runtime call inside
    it over the median runtime call (``runtime_calls``: ``[start, end]``
    ns, sorted by start)."""
    if not runtime_calls:
        return [(r["end_ns"] - r["start_ns"]) / 1e6 for r in ticks]
    median = statistics.median(b - a for a, b in runtime_calls)
    starts = [a for a, _ in runtime_calls]
    out = []
    for r in ticks:
        t0, t1 = r["start_ns"], r["end_ns"]
        wait = 0
        for a, b in runtime_calls[bisect.bisect_left(starts, t0):
                                  bisect.bisect_left(starts, t1)]:
            wait += max(0, min(b, t1) - a - median)
        out.append((t1 - t0 - wait) / 1e6)
    return out


def host_issue_ms_per_tick(ctx):
    """The host's ms to issue a slice tick, the launch-queue wait left
    out: the mean of ``issue_ms`` over the slice's ticks."""
    recs = slice_records(ctx)
    trace = ctx.get("trace") if ctx else None
    if recs is None or not trace or "runtime_calls" not in trace:
        return None
    ticks = [r for r in recs if r["name"] == TICK]
    if not ticks:
        return None
    return statistics.fmean(issue_ms(ticks, trace["runtime_calls"]))


def _innermost(records, starts, at_ns):
    """The name of the innermost record whose host interval covers
    ``at_ns``, or ``OUTSIDE``. Records nest, each with its ``parent``
    index into ``records``, in entry order; ``starts`` are their starts."""
    i = bisect.bisect_right(starts, at_ns) - 1
    while i is not None and i >= 0:
        r = records[i]
        if r["start_ns"] <= at_ns < (r["end_ns"] or 0):
            return r["name"]
        i = r["parent"]
    return OUTSIDE


def idle_by_span(ctx):
    """Seconds of the card's idle gaps in the slice by the innermost span
    the host was in at each gap's midpoint, or None."""
    if not ctx or not ctx.get("spans") or not ctx.get("trace"):
        return None
    merged = ctx["trace"].get("device_intervals")
    if merged is None:
        return None
    records = ctx["spans"]
    starts = [r["start_ns"] for r in records]
    out: dict[str, float] = {}
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        name = _innermost(records, starts, (end + nxt) // 2)
        out[name] = out.get(name, 0.0) + (nxt - end) / 1e9
    return out


def active_shares(ctx):
    """``(all, per slot)``: rows ``fused_place`` attempted over the rows
    it read, over the traced batch, or None where nothing was counted."""
    counts = (ctx.get("counters") or {}).get(COUNTER) if ctx else None
    if not counts or "slice" not in ctx:
        return None
    rows = ctx["fleet"]["replicas"] * ctx["slice"]["batch_ticks"]
    per_slot = [do / rows for do, _ in counts]
    return sum(do for do, _ in counts) / (rows * len(counts)), per_slot


def committed(ctx):
    """Rows ``fused_place`` committed over the traced batch, by its own
    counters, or None."""
    counts = (ctx.get("counters") or {}).get(COUNTER) if ctx else None
    return sum(ok for _, ok in counts) if counts else None


def phase_table(ctx) -> list:
    """Rows of ``(phase, count, device ms, self device ms, host ms, self
    host ms, idle ms)`` over the slice, each time a tick's mean but the
    idle ms, which is the slice's total."""
    at = _slice_indices(ctx)
    if not at:
        return []
    n = ctx["slice"]["ticks"]
    kids_host: dict[int, int] = {}
    kids_dev: dict[int, float] = {}
    for i in at:
        r = ctx["spans"][i]
        if r["parent"] is not None:
            kids_host[r["parent"]] = (kids_host.get(r["parent"], 0)
                                      + r["end_ns"] - r["start_ns"])
            kids_dev[r["parent"]] = (kids_dev.get(r["parent"], 0.0)
                                     + (r["device_ms"] or 0.0))
    idle = idle_by_span(ctx) or {}
    rows: dict[str, list] = {}
    for i in at:
        r = ctx["spans"][i]
        host = (r["end_ns"] - r["start_ns"]) / 1e6
        dev = r["device_ms"]
        row = rows.setdefault(r["name"], [0, 0.0, 0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += (dev or 0.0) / n
        row[2] += ((dev or 0.0) - kids_dev.get(i, 0.0)) / n
        row[3] += host / n
        row[4] += (host - kids_host.get(i, 0) / 1e6) / n
    out = [(name, *row, 1e3 * idle.get(name, 0.0))
           for name, row in rows.items()]
    out.append((OUTSIDE, 0, 0.0, 0.0, 0.0, 0.0,
                1e3 * idle.get(OUTSIDE, 0.0)))
    return out
