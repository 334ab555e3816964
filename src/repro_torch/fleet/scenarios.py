"""Scenario registry: per-replica workload arrays for the fleet engine.

A *scenario* turns (seed, batch, frames, devices) into the two arrays the
batched engine consumes:

    values    i8[F, B, Dev]   frame workload value per device per frame
                              (-1 no object, 0 HP only, 1..4 HP + n LP DNN
                              tasks — the trace alphabet of sim/traces.py)
    bw_scale  f32[F, B]       multiplicative link-bandwidth factor per
                              frame period (1.0 = nominal §V 20 Mbit/s)

The paper's trace families (uniform / weighted1..4, §V) are reproduced
exactly from sim/traces.py's probability tables.  Three new families come
from related work:

- ``poisson_burst`` — Poisson arrivals with a two-state (Gilbert) burst
  process multiplying the rate, the SimPy-DES exemplar's M/M/1-style
  open-loop workload (SNIPPETS.md §2).
- ``diurnal`` — sinusoidal rate modulation (day/night load on a shared
  edge site).
- ``mobility`` — uniform workload but a random-waypoint-style bandwidth
  walk with hard handover dips, the homogeneous-network churn regime of
  Cotter et al. (arXiv 2504.16792) / the adaptive-offload exemplar
  (SNIPPETS.md §3).

Every scenario additionally honours a ``congestion`` level in [0, 1): the
duty-cycle of link-saturating bursts (§VI.C's Packet_MMAP generator),
applied on top of the scenario's own bandwidth process.

Generation is vectorised host-side numpy (one draw for the whole
[F, B, Dev] block); the arrays are then donated to the jitted scan.
"""

from __future__ import annotations

import zlib
from typing import Callable, NamedTuple

import numpy as np

from repro_torch.sim.traces import VALUES, _uniform_probs, _weighted_probs

#: Bandwidth multiplier during a §VI.C congestion burst (CongestionModel's
#: default ``intensity=0.8`` leaves 20% of nominal throughput).
BURST_RESIDUAL = 0.2


class Workload(NamedTuple):
    values: np.ndarray     # i8[F, B, Dev]
    bw_scale: np.ndarray   # f32[F, B]


_REGISTRY: dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def scenario_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_workload(name: str, batch: int, n_frames: int, n_devices: int = 4,
                  *, seed: int = 0, congestion: float = 0.0,
                  **params) -> Workload:
    """Build one scenario's workload for ``batch`` independent replicas.

    ``seed`` keys the whole batch; replica ``b`` reads column ``b`` of a
    single vectorised draw, so (seed, b) is a reproducible stream.
    """
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown scenario {name!r}; known: {scenario_names()}"
        )
    # crc32, not hash(): the stream must be stable across processes
    # (PYTHONHASHSEED salts str hashes per interpreter).
    rng = np.random.default_rng(
        np.random.SeedSequence([zlib.crc32(name.encode()) & 0xFFFF, seed])
    )
    values, bw = _REGISTRY[name](rng, n_frames, batch, n_devices, **params)
    if bw is None:
        bw = np.ones((n_frames, batch), np.float32)
    if congestion > 0.0:
        bw = bw * _congestion_bursts(rng, n_frames, batch, congestion)
    return Workload(values.astype(np.int8), bw.astype(np.float32))


def _congestion_bursts(rng, F, B, duty: float) -> np.ndarray:
    """§VI.C generator: each frame period is saturated with probability
    ``duty``; a burst leaves BURST_RESIDUAL of nominal bandwidth."""
    burst = rng.random((F, B)) < duty
    return np.where(burst, BURST_RESIDUAL, 1.0).astype(np.float32)


def _draw_from_probs(rng, probs: dict[int, float], shape) -> np.ndarray:
    vals = np.array(VALUES, np.int8)
    p = np.array([probs[v] for v in VALUES], np.float64)
    return rng.choice(vals, size=shape, p=p / p.sum())


# ---------------------------------------------------------------------------
# paper traces (§V)
# ---------------------------------------------------------------------------

@register("uniform")
def _uniform(rng, F, B, Dev):
    return _draw_from_probs(rng, _uniform_probs(), (F, B, Dev)), None


def _make_weighted(x: int):
    @register(f"weighted{x}")
    def _weighted(rng, F, B, Dev, _x=x):
        return _draw_from_probs(rng, _weighted_probs(_x), (F, B, Dev)), None

    return _weighted


for _x in (1, 2, 3, 4):
    _make_weighted(_x)


# ---------------------------------------------------------------------------
# related-work workloads
# ---------------------------------------------------------------------------

@register("poisson_burst")
def _poisson_burst(rng, F, B, Dev, *, lam: float = 1.6,
                   burst_factor: float = 3.0, p_enter: float = 0.08,
                   p_exit: float = 0.35):
    """Open-loop Poisson arrivals with Gilbert on/off rate bursts."""
    # two-state Markov chain per replica, advanced over frames
    state = np.zeros((B,), bool)
    bursty = np.empty((F, B), bool)
    for f in range(F):  # F steps of a B-wide chain (host-side, cheap)
        u = rng.random(B)
        state = np.where(state, u >= p_exit, u < p_enter)
        bursty[f] = state
    rate = np.where(bursty, lam * burst_factor, lam)[:, :, None]  # [F,B,1]
    k = rng.poisson(rate, size=(F, B, Dev))
    values = np.where(k == 0, -1, np.minimum(k, 4)).astype(np.int8)
    return values, None


@register("diurnal")
def _diurnal(rng, F, B, Dev, *, lam: float = 1.8, amplitude: float = 0.8,
             period_frames: float = 48.0):
    """Sinusoidal day/night load: rate = lam·(1 + amp·sin(2πf/period))."""
    f = np.arange(F, dtype=np.float64)
    phase = rng.uniform(0, 2 * np.pi, size=(B,))
    rate = lam * (
        1.0 + amplitude * np.sin(2 * np.pi * f[:, None] / period_frames
                                 + phase[None, :])
    )
    rate = np.clip(rate, 0.05, None)[:, :, None]
    k = rng.poisson(rate, size=(F, B, Dev))
    values = np.where(k == 0, -1, np.minimum(k, 4)).astype(np.int8)
    return values, None


@register("mobility")
def _mobility(rng, F, B, Dev, *, walk_sigma: float = 0.08,
              handover_rate: float = 0.04, handover_depth: float = 0.05,
              floor: float = 0.15):
    """Uniform workload under mobility-driven bandwidth churn.

    Log-space random walk (slow fading as the fleet's devices move) with
    Poisson handover events: a handover frame collapses bandwidth to
    ``handover_depth`` (association gap), after which the walk restarts
    from a freshly drawn attachment quality.
    """
    values = _draw_from_probs(rng, _uniform_probs(), (F, B, Dev))
    log_bw = np.zeros((B,))
    scale = np.empty((F, B), np.float64)
    for f in range(F):
        log_bw = log_bw + rng.normal(0.0, walk_sigma, size=B)
        log_bw = np.clip(log_bw, np.log(floor), np.log(1.2))
        handover = rng.random(B) < handover_rate
        scale[f] = np.where(handover, handover_depth, np.exp(log_bw))
        # re-association: new cell, new attachment quality
        log_bw = np.where(
            handover, rng.normal(-0.2, 0.3, size=B).clip(np.log(floor), 0.2),
            log_bw,
        )
    return values, scale
