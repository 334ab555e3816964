"""Deadline-constrained DNN serving engine, in PyTorch: the port of
``repro/serving/engine.py``.

The engine serves the waste-classification pipeline (§III) with real model
execution: stage 1 (object detection, high-priority, local) and stage 3
(classification, low-priority, offloadable) are forward passes of
:class:`repro_torch.models.transformer.Model`. Placement decisions come
from the paper's RAS scheduler (or the WPS baseline); stage latencies are
measured on the engine's device at startup, synchronising the card around
the timed calls.

Workers are logical executors whose clock advances by the scheduler's
task times; the forward passes themselves run on the engine's one device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.core.scheduler import RASScheduler, SchedulerBase
from repro_torch.core.tasks import HP_CONFIG, LPRequest, Priority, Task
from repro_torch.core.wps import WPSScheduler
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model

#: forward passes run by serving engines since the last reset (counted like
#: the kernels' launches, so a run can tie launches to forward passes)
forwards = 0


@dataclasses.dataclass
class StageProfile:
    """Measured execution profile of one pipeline stage."""

    name: str
    fn: Callable        # forward: batch -> logits
    latency: float      # measured seconds/invocation
    batch: dict         # template inputs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure(fn, batch, device, iters: int = 3) -> float:
    fn(batch)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(batch)
    _sync(device)
    return (time.perf_counter() - t0) / iters


@dataclasses.dataclass
class ServeResult:
    frame_id: int
    completed: bool
    deadline: float
    finish_time: float
    offloaded: int
    logits_checksum: float


class ServingEngine:
    """``device`` None -> CUDA (raises without it). ``model``: a ready
    :class:`Model` for ``model_cfg`` (e.g. with carried weights) on that
    device; without one the engine draws the weights from ``seed``."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        n_workers: int = 4,
        scheduler: str = "ras",
        bandwidth_bps: float = 20e6,
        seed: int = 0,
        time_scale: Optional[float] = None,
        *,
        device=None,
        model: Optional[Model] = None,
    ):
        self.cfg = model_cfg
        self.device = resolve_device(device)
        self.model = model if model is not None else Model(
            model_cfg, seed=seed, device=self.device)
        self.n_workers = n_workers
        cls = {"ras": RASScheduler, "wps": WPSScheduler}[scheduler]
        self.sched: SchedulerBase = cls(n_workers, bandwidth_bps, seed=seed)
        self.results: list[ServeResult] = []
        self._inflight: list[Task] = []
        self._build_stages()
        # map measured stage latencies onto the scheduler's task configs:
        # the availability windows then reserve real compute time.
        self.time_scale = time_scale or (
            HP_CONFIG.proc_time / max(self.stage1.latency, 1e-4))

    # -- stages --------------------------------------------------------------

    def _forward(self, batch):
        global forwards
        with torch.inference_mode():
            logits, _ = self.model(batch)
        forwards += 1
        return logits

    def _build_stages(self):
        cfg, dev = self.cfg, self.device
        B = 1
        media = torch.zeros((B, cfg.n_media_tokens, cfg.d_model),
                            dtype=torch.float32, device=dev)
        batch1 = {"tokens": torch.zeros((B, 4), dtype=torch.int32,
                                        device=dev), "media": media}
        self.stage1 = StageProfile(
            "detect", self._forward, _measure(self._forward, batch1, dev),
            batch1)
        # stage 3: high-complexity classifier = longer text head over the
        # same backbone (more query tokens ≈ more compute)
        batch3 = {"tokens": torch.zeros((B, 64), dtype=torch.int32,
                                        device=dev), "media": media}
        self.stage3 = StageProfile(
            "classify", self._forward, _measure(self._forward, batch3, dev),
            batch3)

    # -- serving -------------------------------------------------------------

    def _advance(self, now: float) -> None:
        """Retire finished tasks (mirrors the testbed's completion
        messages) and prune stale availability windows, so the scheduler's
        view tracks real time instead of accumulating forever."""
        for t in list(self._inflight):
            if t.end_time is not None and t.end_time <= now:
                self.sched.complete(t, now)
                self._inflight.remove(t)
        if hasattr(self.sched, "devices") and hasattr(self.sched.devices[0],
                                                      "lists"):
            for dev in self.sched.devices:
                for al in dev.lists.values():
                    for track in al.tracks:
                        for w in [w for w in track if w.t2 <= now]:
                            track.remove(w)
                dev.prune(now)

    @staticmethod
    def _checksum(logits) -> float:
        return logits.float().sum().item()

    def submit_frame(
        self, frame_id: int, source_worker: int, n_classifications: int,
        now: float, deadline_s: float = 2.0 * 18.86,
    ) -> ServeResult:
        """Schedule + execute one frame: HP detect locally, then n LP
        classification tasks wherever the scheduler placed them."""
        self._advance(now)
        hp = Task(Priority.HIGH, source_worker, now, now + 3.0, frame_id)
        res_hp = self.sched.schedule_hp(hp, now)
        checksum = 0.0
        offl = 0
        finish = now
        ok = res_hp.success
        if ok:
            self._inflight.append(hp)
            checksum += self._checksum(self.stage1.fn(self.stage1.batch))
            finish = hp.end_time
        if ok and n_classifications > 0:
            tasks = [
                Task(Priority.LOW, source_worker, finish, now + deadline_s,
                     frame_id)
                for _ in range(n_classifications)
            ]
            req = LPRequest(tasks, source_worker, finish)
            res_lp = self.sched.schedule_lp(req, finish)
            ok = res_lp.success
            if ok:
                self._inflight.extend(tasks)
                for t in tasks:
                    checksum += self._checksum(
                        self.stage3.fn(self.stage3.batch))
                    offl += int(t.offloaded)
                    finish = max(finish, t.end_time)
                ok = all(t.end_time <= t.deadline for t in tasks)
        result = ServeResult(
            frame_id=frame_id,
            completed=bool(ok and finish <= now + deadline_s),
            deadline=now + deadline_s,
            finish_time=finish,
            offloaded=offl,
            logits_checksum=checksum,
        )
        self.results.append(result)
        return result

    def completion_rate(self) -> float:
        if not self.results:
            return 0.0
        return sum(r.completed for r in self.results) / len(self.results)
