"""In-loop fleet telemetry: per-tick time series captured inside
``fleet_run``'s tick loop.

Counterpart of ``repro/obs/telemetry.py``, with the same series, dtypes
and ``.npz`` layout, so a recording saved by either package loads in the
other. When ``FleetParams.telemetry`` is on, the engine calls
``capture_tick`` at the end of every tick ``f`` with ``f %
telemetry_every == 0`` (the global ticks 0, k, 2k, ... that the
reference keeps) and keeps the returned ``TelemetryFrame`` of tensors on
the fleet's device; each segment's rows are stacked there, copied to the
host once, and ``assemble`` concatenates them into a ``TelemetryRecord``
of numpy arrays.

The capture is read-only over the carry: a telemetry-on run is
bit-identical in ``FleetState``/``FleetStats`` to a telemetry-off run,
the same discipline as ``REPRO_SANITIZE``.

Series (leading axis S = recorded ticks):

    free_windows   i32[S, B, Dev]  valid availability-window slots/device
    free_time      f32[S, B, Dev]  free seconds within the next frame
                                   period per device (all configs/tracks)
    hp_run_dev     i32[S, B, Dev]  HP tasks admitted this tick per device
    hp_fail_dev    i32[S, B, Dev]  HP admission failures per device
    preempt_dev    i32[S, B, Dev]  committed preemptions per device
    lp_placed_dev  i32[S, B, Dev]  LP placements per source device
    rq_depth       i32[S, B]       re-queue buffer occupancy (end of tick)
    link_free      f32[S, B]       serial-link FIFO head (absolute sim-t)
    bandwidth_bps  f32[S, B]       effective link bandwidth this tick
    *_d            i32[S, B]       per-tick deltas of the FleetStats
                                   preemption/admission counters
"""

from __future__ import annotations

import json
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.tasks import FRAME_PERIOD
from repro_torch.core.tensor_state import _seq_sum


class TelemetryFrame(NamedTuple):
    """One tick of in-loop series (leaves gain a leading [S] when stacked)."""

    free_windows: Any        # i32[B, Dev]
    free_time: Any           # f32[B, Dev]
    hp_run_dev: Any          # i32[B, Dev]
    hp_fail_dev: Any         # i32[B, Dev]
    preempt_dev: Any         # i32[B, Dev]
    lp_placed_dev: Any       # i32[B, Dev]
    rq_depth: Any            # i32[B]
    link_free: Any           # f32[B]
    bandwidth_bps: Any       # f32[B]
    hp_completed_d: Any      # i32[B]
    hp_failed_d: Any         # i32[B]
    hp_preempted_d: Any      # i32[B]
    lp_spawned_d: Any        # i32[B]
    lp_completed_d: Any      # i32[B]
    lp_failed_d: Any         # i32[B]
    lp_requeued_d: Any       # i32[B]
    missed_by_preemption_d: Any  # i32[B]


def capture_tick(st, link_free, rq_valid, stats_prev, stats_now, base,
                 bw_scale, nominal_bw_bps: float,
                 hp_run_dev, hp_fail_dev, preempt_dev,
                 lp_placed_dev) -> TelemetryFrame:
    """Build one tick's TelemetryFrame from the end-of-tick carry.

    ``st``/``link_free``/``rq_valid``/``stats_now`` are the end-of-tick
    carry components; ``stats_prev`` is the carry entering the tick, so
    the ``*_d`` series are exact per-tick counter deltas. ``base`` is the
    tick's time, an f32 tensor. The per-device counts are bool or integer
    ``[B, Dev]``. Purely read-only.
    """
    # free capacity within the upcoming frame period, per device; the
    # period's end is rounded twice, ``f32(base) + FRAME_PERIOD``, as the
    # reference's compiled tick rounds it (a fused multiply-add from the
    # tick index, which the engine's deadlines need, differs here)
    t1 = torch.maximum(st.win_t1, base)
    t2 = torch.minimum(st.win_t2, base + FRAME_PERIOD)
    gap = torch.where(st.win_valid, torch.clamp(t2 - t1, min=0.0), 0.0)
    # the 3 x 2 x 16 lanes of a device summed one add at a time, in
    # order, as XLA sums them on the host (torch.sum associates otherwise
    # and differs in the last bit)
    free_time = _seq_sum(gap.flatten(2))
    free_windows = st.win_valid.flatten(2).sum(2, dtype=torch.int32)

    def delta(field: str):
        return (getattr(stats_now, field)
                - getattr(stats_prev, field)).to(torch.int32)

    def i32(x):
        return x.to(torch.int32)

    return TelemetryFrame(
        free_windows=free_windows,
        free_time=free_time,
        hp_run_dev=i32(hp_run_dev),
        hp_fail_dev=i32(hp_fail_dev),
        preempt_dev=i32(preempt_dev),
        lp_placed_dev=i32(lp_placed_dev),
        rq_depth=rq_valid.sum(1, dtype=torch.int32),
        link_free=link_free,
        bandwidth_bps=(bw_scale * nominal_bw_bps).to(torch.float32),
        hp_completed_d=delta("hp_completed"),
        hp_failed_d=delta("hp_failed"),
        hp_preempted_d=delta("hp_preempted"),
        lp_spawned_d=delta("lp_spawned"),
        lp_completed_d=delta("lp_completed"),
        lp_failed_d=delta("lp_failed"),
        lp_requeued_d=delta("lp_requeued"),
        missed_by_preemption_d=delta("missed_by_preemption"),
    )


def stack_frames(frames: list[TelemetryFrame]) -> TelemetryFrame:
    """One segment's per-tick frames as one frame of ``[S, ...]``
    tensors, on the frames' device."""
    return TelemetryFrame(*(torch.stack(xs) for xs in zip(*frames)))


def frame_to_numpy(frame: TelemetryFrame) -> TelemetryFrame:
    """The same series as numpy arrays on the host (one copy a leaf)."""
    return TelemetryFrame(*(x.cpu().numpy() for x in frame))


class TelemetryRecord(NamedTuple):
    """Host-side recording: numpy series plus the metadata needed to
    place them on an absolute timeline."""

    ticks: np.ndarray        # i64[S] global frame indices of each row
    series: TelemetryFrame   # numpy leaves, leading axis [S]
    n_frames: int
    every: int
    frame_period: float
    nominal_bw_bps: float

    @property
    def n_replicas(self) -> int:
        return int(self.series.rq_depth.shape[1])

    @property
    def n_devices(self) -> int:
        return int(self.series.free_windows.shape[2])

    def times(self) -> np.ndarray:
        """Absolute sim-time (s) of each recorded tick."""
        return self.ticks.astype(np.float64) * self.frame_period

    def save(self, path: str) -> None:
        meta = {
            "n_frames": int(self.n_frames),
            "every": int(self.every),
            "frame_period": float(self.frame_period),
            "nominal_bw_bps": float(self.nominal_bw_bps),
        }
        arrays = {f"series_{k}": v for k, v in self.series._asdict().items()}
        np.savez_compressed(
            path, ticks=self.ticks,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            **arrays,
        )

    def to_jsonl(self, path: str, replica: int = 0) -> None:
        """Compact one-line-per-tick JSONL view of a single replica."""
        s = self.series
        with open(path, "w") as f:
            for i, tick in enumerate(self.ticks):
                row = {
                    "tick": int(tick),
                    "t": round(float(tick) * self.frame_period, 6),
                    "rq_depth": int(s.rq_depth[i, replica]),
                    "bandwidth_bps": float(s.bandwidth_bps[i, replica]),
                    "link_free": float(s.link_free[i, replica]),
                    "free_windows": s.free_windows[i, replica].tolist(),
                    "free_time": [round(float(x), 4)
                                  for x in s.free_time[i, replica]],
                    "preempt_dev": s.preempt_dev[i, replica].tolist(),
                    "hp_fail_dev": s.hp_fail_dev[i, replica].tolist(),
                    "hp_completed_d": int(s.hp_completed_d[i, replica]),
                    "lp_completed_d": int(s.lp_completed_d[i, replica]),
                    "missed_d": int(s.missed_by_preemption_d[i, replica]),
                }
                f.write(json.dumps(row) + "\n")


def assemble(segments: list[TelemetryFrame], *, n_frames: int, every: int,
             nominal_bw_bps: float,
             n_replicas: int | None = None) -> TelemetryRecord:
    """Concatenate per-segment strided series (numpy leaves), trim rows
    past the trace, and return a numpy TelemetryRecord.

    The rows sit at global ticks ``0, every, 2*every, ...``; rows landing
    past the true trace length are cut. ``n_replicas`` trims the batch
    axis to the caller's true B (the sharded engine pads B to a multiple
    of the shard count; padded columns are synthetic no-op replicas and
    must not leak into recordings).
    """
    np_segs = [
        TelemetryFrame(*(np.asarray(x)[:, :n_replicas] for x in seg))
        for seg in segments
    ]
    series = TelemetryFrame(*(
        np.concatenate([getattr(seg, f) for seg in np_segs], axis=0)
        for f in TelemetryFrame._fields
    ))
    total = series.rq_depth.shape[0]
    ticks = np.arange(total, dtype=np.int64) * every
    keep = ticks < n_frames
    series = TelemetryFrame(*(x[keep] for x in series))
    return TelemetryRecord(
        ticks=ticks[keep], series=series, n_frames=int(n_frames),
        every=int(every), frame_period=float(FRAME_PERIOD),
        nominal_bw_bps=float(nominal_bw_bps),
    )


def load_record(path: str) -> TelemetryRecord:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        series = TelemetryFrame(*(
            z[f"series_{f}"] for f in TelemetryFrame._fields
        ))
        return TelemetryRecord(
            ticks=z["ticks"], series=series, n_frames=meta["n_frames"],
            every=meta["every"], frame_period=meta["frame_period"],
            nominal_bw_bps=meta["nominal_bw_bps"],
        )
