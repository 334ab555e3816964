"""Trace-file workload model (§V).

Each trace entry is the workload of all devices for one frame period.  A
device's value per frame is one of:

    -1      no object detected (no tasks)
     0      HP task only (object detected, not recyclable path)
     1..4   HP task, then an LP request with n DNN tasks once HP completes

Distributions (§V): *uniform* draws 1..4 with equal probability; *weighted
X* predominantly draws X, so network load rises with X.
"""

from __future__ import annotations

import dataclasses

import numpy as np

VALUES = (-1, 0, 1, 2, 3, 4)


def _weighted_probs(x: int) -> dict[int, float]:
    """Predominantly generate ``x`` tasks (§V)."""
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


@dataclasses.dataclass
class Trace:
    """``entries[f][d]`` = workload value of device ``d`` in frame ``f``."""

    name: str
    entries: np.ndarray  # [frames, devices] int8

    @property
    def n_frames(self) -> int:
        return self.entries.shape[0]

    @property
    def n_devices(self) -> int:
        return self.entries.shape[1]

    def total_lp_tasks(self) -> int:
        return int(np.clip(self.entries, 0, None).sum())


def generate_trace(
    kind: str,
    n_frames: int,
    n_devices: int = 4,
    seed: int = 0,
) -> Trace:
    """``kind`` is ``uniform`` or ``weighted{1..4}``."""
    if kind == "uniform":
        probs = _uniform_probs()
    elif kind.startswith("weighted"):
        probs = _weighted_probs(int(kind[len("weighted"):]))
    else:
        raise ValueError(f"unknown trace kind: {kind}")
    rng = np.random.default_rng(seed)
    vals = np.array(VALUES, dtype=np.int8)
    p = np.array([probs[v] for v in VALUES])
    p = p / p.sum()
    entries = rng.choice(vals, size=(n_frames, n_devices), p=p)
    return Trace(kind, entries)
