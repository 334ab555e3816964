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

On a mesh (DTensors, ``launch/sharding.py``) it counts what one rank runs,
as the reference's per-partition HLO does: the mode declines every op on
DTensors (it returns ``NotImplemented``), so DTensor splits the op into
the ops on the local shards and the collectives, which the mode then sees
and counts, each as it runs. It never divides a global count by the mesh
size. The ops DTensor runs on fake tensors to propagate shapes are not
counted. Each collective (``_c10d_functional``) is counted by kind with the
reference's wire bytes (``repro/roofline/hlo.py``): an all-gather its
result's bytes, an all-reduce twice its operand's, the others their
operand's; and by the ranks of its group (``wire_by_group``), which
``terms.py`` charges at the link between them.
"""

from __future__ import annotations

import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

#: the reference's collective kinds (``hlo.py``'s keys)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}


def tensor_bytes(tree) -> int:
    """numel × itemsize summed over the tensors of ``tree`` (a pytree):
    what the reference's ``_tree_bytes`` sums over its leaves. A DTensor
    counts its global shape."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def local_bytes(tree) -> int:
    """``tensor_bytes`` of what this rank holds: a DTensor counts its
    local shard."""
    return tensor_bytes([t.to_local() if isinstance(t, DTensor) else t
                         for t in tree_leaves(tree)])


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _fake_mode() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _group_ranks(name: str) -> tuple:
    pg = dist.distributed_c10d._resolve_process_group(name)
    return tuple(dist.get_process_group_ranks(pg))


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
        self.collectives = dict.fromkeys(KINDS, 0)
        self.wire_by_group: dict[tuple, int] = {}
        self._sizes: dict[int, int] = {}
        for t in tree_leaves(args):
            if isinstance(t, torch.Tensor):
                self._hold(_local(t))
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

    def _collective(self, func, args, out) -> None:
        kind = _FUNCTIONAL.get(func._overloadpacket.__name__)
        if func.namespace != "_c10d_functional" or kind is None:
            return
        wire = tensor_bytes(out) if kind == "all-gather" else \
            tensor_bytes(args[0]) * (2 if kind == "all-reduce" else 1)
        self.collectives[kind] += wire
        group = _group_ranks(args[-1])
        self.wire_by_group[group] = self.wire_by_group.get(group, 0) + wire

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(t, DTensor) for t in leaves):
            return NotImplemented
        if _fake_mode() or any(isinstance(t, FakeTensor) for t in leaves):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self._collective(func, args, out)
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
        ``arg_bytes``, ``peak_bytes``, ``temp_bytes``; ``collectives``
        (wire bytes by kind and ``total_wire_bytes``, the reference's
        keys) and ``wire_by_group`` (group ranks -> wire bytes)."""
        coll = {k: float(v) for k, v in self.collectives.items()}
        coll["total_wire_bytes"] = float(sum(self.collectives.values()))
        return {"dot_flops": float(self.dot_flops),
                "dot_bytes": float(self.dot_bytes),
                "arg_bytes": self.arg_bytes,
                "peak_bytes": self.peak_bytes,
                "temp_bytes": self.peak_bytes - self.arg_bytes,
                "collectives": coll,
                "wire_by_group": dict(self.wire_by_group)}
