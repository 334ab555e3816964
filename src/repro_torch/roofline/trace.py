"""A step's dot FLOPs, dot bytes and peak live bytes, counted as the eager
program runs: the port of ``repro/roofline/hlo_graph.py::analyze`` and of
the compiled step's ``memory_analysis()``.

The reference compiles a step and walks its HLO text, weighting every
``dot`` by the trip count of the loop it sits in. The port has no HLO: it
runs the step, usually on the ``meta`` device (shapes only, nothing
allocated, nothing computed), under ``StepTrace``, a ``TorchDispatchMode``
that sees every aten op as it runs, so a loop's body is counted as often
as it runs:

- **dot FLOPs**: every op of ``torch.utils.flop_counter``'s registry
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, the fused
  attentions) by the registry's formula, 2 · M · N · K for a product;
- **dot bytes**: the same ops' operand bytes plus result bytes, what the
  reference's ``weighted_dot_bytes`` counts;
- **peak live bytes**: the bytes of the storages alive, from the
  arguments alive when the trace starts; each storage is counted once,
  whatever its views, and leaves the count when it is freed (a
  ``weakref.finalize`` on it). ``temp_bytes`` is the peak less the
  arguments, the reference's ``temp_size_in_bytes``.

The same mode runs on a CUDA or CPU tensor; there it also counts what a
kernel wrapper computes through aten ops, and nothing a custom kernel
computes.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry


def tensor_bytes(tree) -> int:
    """numel × itemsize summed over the tensors of ``tree`` (a pytree):
    what the reference's ``_tree_bytes`` sums over its leaves."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class StepTrace(TorchDispatchMode):
    """Counts dot FLOPs, dot bytes and live storage bytes of the ops run
    under it. ``args`` (a pytree of tensors) are the step's arguments,
    alive from the start."""

    def __init__(self, args=()):
        super().__init__()
        self.dot_flops = 0
        self.dot_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._sizes: dict[int, int] = {}
        for t in tree_leaves(args):
            if isinstance(t, torch.Tensor):
                self._hold(t)
        self.arg_bytes = self.live_bytes

    def _hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._sizes:
            return
        n = storage.nbytes()
        self._sizes[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._release, key).atexit = False

    def _release(self, key: int) -> None:
        self.live_bytes -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.dot_flops += formula(*args, **kwargs, out_val=out)
            self.dot_bytes += tensor_bytes((args, kwargs, out))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._hold(t)
        return out

    def counts(self) -> dict:
        """The counts so far: ``dot_flops``, ``dot_bytes``,
        ``arg_bytes``, ``peak_bytes``, ``temp_bytes``."""
        return {"dot_flops": float(self.dot_flops),
                "dot_bytes": float(self.dot_bytes),
                "arg_bytes": self.arg_bytes,
                "peak_bytes": self.peak_bytes,
                "temp_bytes": self.peak_bytes - self.arg_bytes}
