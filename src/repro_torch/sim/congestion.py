"""Link condition model: congestion bursts + piecewise-constant bandwidth.

§VI.C: a Packet_MMAP-style traffic generator emits 1024-byte frame bursts
with a configurable *duty cycle* of the bandwidth-update interval (30 s in
the paper's congestion tests).  During the active part of each cycle the
available link bandwidth drops by ``intensity``.

The model exposes:
- ``bw(t)``            instantaneous available bandwidth (bps)
- ``busy_fraction(t)`` probability a probe ping collides with an ongoing
                       image transfer (tracked from actual transfer activity)
- ``transfer_end(start, nbytes)``  integrate the piecewise bandwidth to get
                       the *actual* completion time of a transfer
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CongestionModel:
    """True link state = nominal × slow Wi-Fi random walk × burst factor.

    The random walk models 802.11n throughput variability (fading, channel
    contention): piecewise-constant per ``walk_step`` seconds, lognormal
    steps, clamped to [walk_lo, walk_hi].  Deterministic per seed.
    """

    nominal_bps: float
    duty_cycle: float = 0.0          # 0, 0.25, 0.50, 0.75 (§VI.C)
    period: float = 30.0             # one burst cycle = bandwidth interval
    intensity: float = 0.6           # fraction of capacity consumed in burst
    phase: float = 0.0
    walk_sigma: float = 0.05         # per-step lognormal sigma (0 disables)
    walk_step: float = 5.0
    walk_lo: float = 0.72
    walk_hi: float = 1.2
    horizon: float = 7200.0
    seed: int = 0
    # Active-probe channel occupancy (§VI.B): 30 serialised pings cost
    # ~6 ms of 802.11 channel time each (contention + ACK), so every probe
    # round blocks roughly half the medium for ~0.18 s — the real reason
    # 1.5 s probing hurts far more than its byte count suggests.
    probe_period: float = 0.0        # 0 disables; engine sets bw_interval
    probe_duration: float = 0.35
    probe_intensity: float = 0.95

    def __post_init__(self) -> None:
        import numpy as np

        n = int(self.horizon / self.walk_step) + 2
        if self.walk_sigma > 0:
            rng = np.random.default_rng(self.seed + 12345)
            steps = rng.normal(0.0, self.walk_sigma, size=n)
            walk = np.exp(np.cumsum(steps) * 0.5)
            walk = np.clip(walk, self.walk_lo, self.walk_hi)
        else:
            walk = np.ones(n)
        self._walk = walk

    def _walk_at(self, t: float) -> float:
        i = int(max(t, 0.0) / self.walk_step)
        return float(self._walk[min(i, len(self._walk) - 1)])

    def in_burst(self, t: float) -> bool:
        if self.duty_cycle <= 0.0:
            return False
        pos = (t - self.phase) % self.period
        return pos < self.duty_cycle * self.period

    def in_probe(self, t: float) -> bool:
        if self.probe_period <= 0.0:
            return False
        return (t % self.probe_period) < self.probe_duration and t >= self.probe_period

    def bw(self, t: float, exclude_probe: bool = False) -> float:
        b = self.nominal_bps * self._walk_at(t)
        if self.in_burst(t):
            b *= 1.0 - self.intensity
        if self.in_probe(t) and not exclude_probe:
            # probe pings themselves occupy the medium; transfers see the
            # residual capacity (the pings do not compete with themselves)
            b *= 1.0 - self.probe_intensity
        return b

    def probe_exit(self, t: float) -> float:
        """A transfer *starting* during a probe round queues behind the
        serialised pings (medium access): returns the probe window's end if
        ``t`` falls inside one, else ``t``.  (Without this, RAS's link
        rebuild — which happens AT the probe instant — would systematically
        cascade reservations into the probe window, a modelling artifact.)"""
        if self.probe_period > 0.0 and self.in_probe(t):
            return (t // self.probe_period) * self.probe_period + self.probe_duration
        return t

    def transfer_end(self, start: float, nbytes: float) -> float:
        """Integrate the piecewise-constant bandwidth until nbytes are sent.
        Change points: burst edges and random-walk steps."""
        bits = nbytes * 8.0
        t = start
        for _ in range(100_000):  # safety bound
            b = max(self.bw(t), 1e3)
            # distance to the next change point
            nxt_walk = (int(t / self.walk_step) + 1) * self.walk_step - t
            if self.duty_cycle > 0.0:
                pos = (t - self.phase) % self.period
                edge = self.duty_cycle * self.period
                nxt_burst = (edge - pos) if pos < edge else (self.period - pos)
            else:
                nxt_burst = float("inf")
            if self.probe_period > 0.0:
                ppos = t % self.probe_period
                nxt_probe = (
                    (self.probe_duration - ppos)
                    if ppos < self.probe_duration
                    else (self.probe_period - ppos)
                )
            else:
                nxt_probe = float("inf")
            nxt = max(min(nxt_walk, nxt_burst, nxt_probe), 1e-9)
            can = b * nxt
            if can >= bits:
                return t + bits / b
            bits -= can
            t += nxt
        return t


class LinkActivity:
    """Tracks actual transfer intervals so probes can estimate how busy the
    link is (collision probability for ping-based estimation; §VI.B)."""

    def __init__(self) -> None:
        self.intervals: list[tuple[float, float]] = []

    def add(self, s: float, e: float) -> None:
        self.intervals.append((s, e))

    def busy_fraction(self, t1: float, t2: float) -> float:
        """Fraction of [t1, t2) during which a transfer was in flight."""
        if t2 <= t1:
            return 0.0
        covered = 0.0
        for s, e in self.intervals:
            lo, hi = max(s, t1), min(e, t2)
            if hi > lo:
                covered += hi - lo
        return min(1.0, covered / (t2 - t1))

    def prune(self, before: float) -> None:
        self.intervals = [(s, e) for s, e in self.intervals if e >= before]
