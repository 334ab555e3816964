"""Frozen copy of the port's paper-trace workload generator.

The §V trace families (``uniform``, ``weighted1`` .. ``weighted4``) and
the §VI.C congestion bursts, drawn exactly as the port's
``fleet/scenarios.py`` draws them at the same seed, so a benchmark's
inputs do not move when the program's generator is changed. The related
work families of the port (Poisson bursts, diurnal, mobility) are left
out: no traffic mix of the benchmark uses them.

A workload is the pair the fleet engine consumes:

    values    i8[F, B, Dev]   frame workload value per device per frame
                              (-1 no object, 0 HP only, 1..4 HP + n LP DNN
                              tasks)
    bw_scale  f32[F, B]       multiplicative link-bandwidth factor per
                              frame period (1.0 = the nominal 20 Mbit/s)
"""

from __future__ import annotations

import zlib

import numpy as np

VALUES = (-1, 0, 1, 2, 3, 4)

#: bandwidth multiplier during a §VI.C congestion burst
BURST_RESIDUAL = 0.2


def _weighted_probs(x: int) -> dict[int, float]:
    """Predominantly ``x`` DNN tasks a frame (§V)."""
    probs = {v: 0.0 for v in VALUES}
    probs[x] = 0.55
    others = [v for v in (1, 2, 3, 4) if v != x]
    for v in others:
        probs[v] = 0.30 / len(others)
    probs[0] = 0.075
    probs[-1] = 0.075
    return probs


def _uniform_probs() -> dict[int, float]:
    probs = {v: 0.0 for v in VALUES}
    for v in (1, 2, 3, 4):
        probs[v] = 0.225
    probs[0] = 0.05
    probs[-1] = 0.05
    return probs


def trace_probs(name: str) -> dict[int, float]:
    if name == "uniform":
        return _uniform_probs()
    if name in ("weighted1", "weighted2", "weighted3", "weighted4"):
        return _weighted_probs(int(name[len("weighted"):]))
    raise ValueError(f"unknown paper trace {name!r}")


def paper_workload(name: str, batch: int, n_frames: int, n_devices: int = 4,
                   *, seed: int = 0, congestion: float = 0.0):
    """``(values, bw_scale)`` of one paper trace for ``batch`` replicas.

    ``seed`` keys the whole batch; replica ``b`` reads column ``b`` of a
    single vectorised draw."""
    probs = trace_probs(name)
    # crc32, not hash(): the stream is the same in every process
    rng = np.random.default_rng(
        np.random.SeedSequence([zlib.crc32(name.encode()) & 0xFFFF, seed])
    )
    vals = np.array(VALUES, np.int8)
    p = np.array([probs[v] for v in VALUES], np.float64)
    values = rng.choice(vals, size=(n_frames, batch, n_devices),
                        p=p / p.sum())
    bw = np.ones((n_frames, batch), np.float32)
    if congestion > 0.0:
        burst = rng.random((n_frames, batch)) < congestion
        bw = bw * np.where(burst, BURST_RESIDUAL, 1.0).astype(np.float32)
    return values.astype(np.int8), bw.astype(np.float32)
