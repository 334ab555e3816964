"""Dynamic bandwidth estimation (§V).

At experiment start the controller runs an iperf3-style baseline test with
each edge device.  Periodically (default 30 s) a randomly chosen edge device
sends ``PROBE_PING_COUNT`` pings of ``PROBE_PING_BYTES`` to every other
device, measures per-ping RTT, converts each to bits/second, and returns the
samples to the controller, which folds their mean into an EWMA (α = 0.3)
and triggers a rebuild + cascade of the network-link discretisation.

Probing is *active*: each round injects ``probe_bytes_total`` onto the link,
and any probe overlapping an ongoing image transfer reads a *lower* apparent
bandwidth (the paper's §VI.B effect: frequent probes both congest the link
and bias the estimate downward).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.tasks import (
    BANDWIDTH_EWMA_ALPHA,
    PROBE_PING_BYTES,
    PROBE_PING_COUNT,
)


@dataclasses.dataclass
class ProbeResult:
    host_device: int
    samples_bps: list[float]
    bytes_injected: int
    duration: float


class BandwidthEstimator:
    """EWMA bandwidth estimator with an iperf-style baseline."""

    def __init__(self, baseline_bps: float, alpha: float = BANDWIDTH_EWMA_ALPHA):
        self.alpha = alpha
        self.baseline_bps = float(baseline_bps)
        self.estimate_bps = float(baseline_bps)
        self.history: list[tuple[float, float]] = []  # (time, estimate)

    def update(self, samples_bps: Sequence[float], now: float = 0.0) -> float:
        # §V: per-ping bits/s samples are returned to the controller, which
        # folds the round's measurement into the EWMA.  Collided pings
        # (queued behind an image transfer) bias the round's mean downward —
        # the §VI.B under-estimation effect, mild per round but compounding
        # at high probe rates.
        if len(samples_bps):
            mean = float(np.mean(samples_bps))
            self.estimate_bps = (
                self.alpha * mean + (1.0 - self.alpha) * self.estimate_bps
            )
        self.history.append((now, self.estimate_bps))
        return self.estimate_bps


class ProbeModel:
    """Models one probe round against the *true* link state.

    ``true_bw_fn(t)`` returns the instantaneous available bandwidth in bps
    (background/congestion already subtracted); ``busy_fraction`` is the
    share of the probe window during which image transfers were in flight —
    concurrent transfers depress the apparent per-ping bandwidth.
    """

    def __init__(self, n_devices: int, rng: np.random.Generator,
                 noise_std: float = 0.05):
        self.n_devices = n_devices
        self.rng = rng
        self.noise_std = noise_std

    def run(
        self,
        now: float,
        true_bw_fn,
        busy_fraction: float = 0.0,
        host_device: Optional[int] = None,
    ) -> ProbeResult:
        if host_device is None:
            host_device = int(self.rng.integers(self.n_devices))
        samples: list[float] = []
        targets = [d for d in range(self.n_devices) if d != host_device]
        for _ in targets:
            for _ in range(PROBE_PING_COUNT):
                bw = true_bw_fn(now)
                # Concurrent image transfers: the ping shares the medium.
                bw = bw * (1.0 - 0.5 * min(busy_fraction, 1.0))
                bw *= max(0.1, 1.0 + self.rng.normal(0.0, self.noise_std))
                samples.append(bw)
        bytes_injected = PROBE_PING_BYTES * PROBE_PING_COUNT * len(targets) * 2  # RTT
        # Probe wall-time: serialized pings at the true bandwidth.
        duration = bytes_injected * 8.0 / max(true_bw_fn(now), 1.0)
        return ProbeResult(host_device, samples, bytes_injected, duration)
