"""The offline prefill pool of ``model_prefill.py``, with the program's
own spans handed to the readers.

Set-up, the window, the check and the end-to-end metrics are
``model_prefill.run``'s, unchanged, with two additions:

- the weights: where the reference names weights that are not drawn from
  N(0, std^2) (``other_weights(config, device, gen)``, such as a
  Mamba-2 mixer's A and dt biases at their published init), the seed's
  generator draws them after the others and they join the weights that
  the program loads and the reference reads;
- with ``--trace 1``, the traced steps run under a device-timed
  ``PhaseTimer`` (``repro_torch/obs/profile.py``): every span the model
  keeps there (``model/mamba2``, ``model/shared_block``) is also timed on
  the card by CUDA events. The readers' context gains ``spans`` (the
  records of the traced steps); where the program keeps no spans, it is
  empty and the readers that need spans read nothing.

The run prints the traced steps' device ms by span name to stderr. A
cell gets this driver by naming it as its traffic mix's ``driver``.
"""

from __future__ import annotations

import contextlib
import importlib
import sys

from chipbench.drivers import model_prefill
from chipbench.trace import TraceSlice


def inputs(config: dict, traffic: dict, ref, seed: int, device):
    """``model_prefill.inputs`` with the reference's other weights."""
    with _other_weights(config, ref):
        return model_prefill.inputs(config, traffic, ref, seed, device)


@contextlib.contextmanager
def _other_weights(config, ref):
    """While the block runs, ``model_prefill.make_weights`` also draws the
    reference's ``other_weights`` from the same generator."""
    extra = getattr(ref, "other_weights", None)
    real = model_prefill.make_weights

    def make_weights(specs, dtype, device, gen):
        weights = real(specs, dtype, device, gen)
        if extra is not None:
            weights.update(extra(config, device, gen))
        return weights

    model_prefill.make_weights = make_weights
    try:
        yield
    finally:
        model_prefill.make_weights = real


def _timed_slice(timers: list):
    """A ``TraceSlice`` class whose steps run under a device-timed
    ``PhaseTimer``, each appended to ``timers``."""

    class TimedSlice(TraceSlice):
        def start(self) -> None:
            super().start()
            try:
                from repro_torch.obs.profile import PhaseTimer
            except ImportError:   # a program without spans
                self._timer = None
            else:
                self._timer = PhaseTimer(device_time=True).__enter__()
                timers.append(self._timer)

        def stop(self) -> dict:
            summary = super().stop()      # synchronizes first
            if self._timer is not None:
                self._timer.__exit__(None, None, None)
            return summary

    return TimedSlice


def run(config: dict, traffic: dict, *, seed: int, seconds: float,
        trace: bool, device, t_start: float, program=None):
    """One run of the cell, as ``model_prefill.run``; traced, with the
    program's spans in the readers' context."""
    ref = importlib.import_module(f"chipbench.reference.{config['reference']}")
    timers: list = []
    plain = model_prefill.TraceSlice
    model_prefill.TraceSlice = _timed_slice(timers)
    try:
        with _other_weights(config, ref):
            out = model_prefill.run(config, traffic, seed=seed,
                                    seconds=seconds, trace=trace,
                                    device=device, t_start=t_start,
                                    program=program)
    finally:
        model_prefill.TraceSlice = plain
    if trace:
        out.context["spans"] = timers[0].records() if timers else []
        _print_spans(out.context)
    return out


def _print_spans(ctx) -> None:
    """The traced steps' device ms by span name, to stderr."""
    by: dict[str, list] = {}
    for r in ctx["spans"]:
        if r["device_ms"] is not None:
            by.setdefault(r["name"], []).append(r["device_ms"])
    if not by:
        print("traced steps: the program kept no spans", file=sys.stderr)
        return
    steps = len(ctx["prefill"]["traced_steps"])
    print(f"traced steps by span ({steps} steps): name count device_ms "
          "device_ms_a_step", file=sys.stderr)
    for name, ms in sorted(by.items()):
        print(f"  {name} {len(ms)} {sum(ms):.3f} {sum(ms) / steps:.3f}",
              file=sys.stderr)
