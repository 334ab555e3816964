"""A device trace of one slice of a run, reduced to what the per-layer
metrics read: the device's busy time (the union of its operations'
intervals), its operations by name, and the idle gaps between them by
what the host was doing.

A slice starts and ends with a ``torch.cuda.synchronize()``, so every
device operation inside it belongs to work issued inside it, and its
wall time is taken on the host clock between the two. Only the raw
events of the profiler are read (not ``profile.events()``, which builds
a tree of every CPU op and takes seconds for a slice of this size).
"""

from __future__ import annotations

import bisect
import time
import warnings

import torch

#: device operations that are not kernel launches
_NOT_LAUNCHES = ("Memcpy", "Memset")
#: host events that say nothing of what the host was doing
_HOST_NOISE = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync",
               "cudaStreamIsCapturing", "cudaPeekAtLastError",
               "cudaGetDevice", "cudaSetDevice")


class TraceSlice:
    """``start()`` and ``stop()`` bound one profiled slice."""

    def __init__(self) -> None:
        self._prof = None
        self._t0 = 0.0
        self.summary: dict | None = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

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
        return self.summary


def _merged(spans) -> list:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_label(cpu, starts, at_ns) -> str:
    """The innermost informative host event running at ``at_ns``: host
    events nest, so it is the covering one that started last. The scan
    back over earlier starts is bounded."""
    i = bisect.bisect_right(starts, at_ns)
    for j in range(i - 1, max(i - 400, -1), -1):
        a, b, name = cpu[j]
        if a <= at_ns < b and not name.startswith(_HOST_NOISE):
            return name
    return "host between ops (Python)"


def short_name(name: str) -> str:
    """A kernel's name without its argument list and namespaces."""
    name = name.removeprefix("void ")
    for ns in ("at::native::", "(anonymous namespace)::", "at::cuda::"):
        name = name.replace(ns, "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut].strip()[:200]


def reduce_events(events, wall_s: float, top: int = 10) -> dict:
    """Busy seconds, device ops by name, launches and idle gaps of a
    slice of ``wall_s`` seconds from the profiler's raw events."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in events:
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((a, b, e.name()))
        elif b > a:
            cpu.append((a, b, e.name()))
    by_name: dict[str, list] = {}
    for a, b, name in dev:
        row = by_name.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (b - a) / 1e9
    merged = _merged((a, b) for a, b, _ in dev)
    busy = sum(b - a for a, b in merged) / 1e9
    cpu.sort()
    starts = [a for a, _, _ in cpu]
    gaps: dict[str, float] = {}
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        label = _host_label(cpu, starts, (end + nxt) // 2)
        gaps[label] = gaps.get(label, 0.0) + (nxt - end) / 1e9
    ops = sorted(((v[1], k) for k, v in by_name.items()), reverse=True)
    return {
        "wall_s": wall_s,
        "busy_s": busy,
        "device_ops": len(dev),
        "launches": sum(v[0] for k, v in by_name.items()
                        if not k.startswith(_NOT_LAUNCHES)),
        "by_name": {k: {"count": v[0], "seconds": v[1]}
                    for k, v in by_name.items()},
        "top_device_ops": [[short_name(k), s] for s, k in ops[:top]],
        "idle_gaps": [[k, s] for k, s in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:top]],
    }


def kernel_time(summary: dict, needle: str):
    """``(launches, seconds)`` of the device ops whose name contains
    ``needle``; ``(0, 0.0)`` where none ran."""
    n, s = 0, 0.0
    for name, row in summary["by_name"].items():
        if needle in name:
            n += row["count"]
            s += row["seconds"]
    return n, s
