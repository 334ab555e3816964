"""The closed-loop fleet sweep of ``fleet_sweep.py``, with the program's
own spans and counters handed to the readers.

Set-up, the window, the check and the end-to-end metrics are
``fleet_sweep.run``'s, unchanged: with ``--trace 0`` this driver runs it
as it is. With ``--trace 1`` the traced batch's timer is device-timed
(``repro_torch/obs/profile.py``): every span of that batch is also timed
on the card by CUDA events, and ``fused_place`` counts its rows
attempted and committed per attempt slot inside the kernel. The profiled
slice also keeps its host runtime calls and merged device intervals, on
the profiler's clock. The readers' context gains ``spans`` (the traced
batch's span records), ``counters``, ``slice`` (its first tick, its
ticks, the batch's ticks) and, in ``trace``, ``runtime_calls`` and
``device_intervals`` (``spans.py`` joins them). The run prints the
slice by span to stderr. Where the program keeps no spans or counters,
those keys are None and the readers that need them read nothing. A cell
gets it by naming it as its traffic mix's ``driver``.
"""

from __future__ import annotations

import sys
import time
import warnings

import torch

from chipbench import spans
from chipbench.drivers import fleet_sweep
from chipbench.trace import TraceSlice, reduce_events


class _SpanSlice(TraceSlice):
    """``TraceSlice`` whose summary also keeps the slice's runtime calls
    and merged device intervals."""

    def stop(self) -> dict:
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        with warnings.catch_warnings():
            # a one-cycle session: its note on later cycles does not apply
            warnings.filterwarnings("ignore", message=".*clears events")
            self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        self.summary = reduce_events(events, wall)
        self.summary.update(spans.intervals(events))
        return self.summary


def run(config: dict, traffic: dict, *, seed: int, seconds: float,
        trace: bool, device, t_start: float, program=None):
    """One run of the cell, as ``fleet_sweep.run``; traced, with the
    program's spans and counters in the readers' context."""
    if not trace:
        return fleet_sweep.run(config, traffic, seed=seed, seconds=seconds,
                               trace=trace, device=device, t_start=t_start,
                               program=program)
    traced = []

    class Timer(fleet_sweep._SegmentTimer):
        """The traced batch's timer, device-timed, profiling with
        ``_SpanSlice`` and kept for the readers."""

        def __init__(self, slice_at=None):
            super().__init__(slice_at)
            if slice_at is not None:
                self.device_time = True
                self.slice = _SpanSlice()
                traced.append(self)

    plain = fleet_sweep._SegmentTimer
    fleet_sweep._SegmentTimer = Timer
    try:
        out = fleet_sweep.run(config, traffic, seed=seed, seconds=seconds,
                              trace=trace, device=device, t_start=t_start,
                              program=program)
    finally:
        fleet_sweep._SegmentTimer = plain
    timer = traced[0]
    ctx = out.context
    # the program's records and counters (a program without them: None)
    ctx["spans"] = timer.records() if hasattr(timer, "records") else None
    ctx["counters"] = (timer.counters() if hasattr(timer, "counters")
                       else None)
    S = config["segment_frames"] or config["frames_per_replica"]
    ctx["slice"] = {"first_tick": S * traffic["trace_segment"],
                    "ticks": ctx["ticks"],
                    "batch_ticks": config["frames_per_replica"]}
    _print_slice(ctx)
    return out


def _print_slice(ctx) -> None:
    """The traced slice by the program's spans, to stderr: each phase's
    device, self device, host and self host ms a tick and the idle ms put
    down to it; the host's issue ms a tick, and its ms a tick outside the
    profiled slice; the rows fused_place attempted, by slot, and its own
    count of commits (``fleet_sweep`` prints the stats'); the device
    events that carry a span's name."""
    rows = spans.phase_table(ctx)
    if not rows:
        print("traced slice: the program kept no spans", file=sys.stderr)
        return
    print("traced slice by span (ms a tick; idle ms in all): phase count "
          "device self_device host self_host idle", file=sys.stderr)
    for name, n, dev, sdev, host, shost, idle in rows:
        print(f"  {name} {n} {dev:.4f} {sdev:.4f} {host:.4f} {shost:.4f} "
              f"{idle:.4f}", file=sys.stderr)
    print("host issue ms a tick, the queue wait left out: "
          f"{spans.host_issue_ms_per_tick(ctx)}", file=sys.stderr)
    # the batch's other ticks ran without the profiler
    first = ctx["slice"]["first_tick"]
    rest = [(r["end_ns"] - r["start_ns"]) / 1e6 for r in ctx["spans"]
            if r["name"] == spans.TICK and not
            first <= r["trace"][1] < first + ctx["slice"]["ticks"]]
    if rest:
        print(f"host ms a tick outside the slice: "
              f"{sum(rest) / len(rest):.4f} over {len(rest)} ticks",
              file=sys.stderr)
    shares = spans.active_shares(ctx)
    if shares is not None:
        print(f"fused_place rows attempted: {100 * shares[0]:.4f}% of its "
              "reads; by slot % " + " ".join(
                  f"{100 * x:.3f}" for x in shares[1]), file=sys.stderr)
        print(f"traced batch: {spans.committed(ctx)} fused_place commits "
              "by its own counters", file=sys.stderr)
    names = {r["name"] for r in ctx["spans"]}
    print("device events named as spans: "
          f"{[k for k in ctx['trace']['by_name'] if k in names]}",
          file=sys.stderr)
