"""Numpy checkpoints in the reference's layout: the port of
``repro/checkpoint/checkpoint.py``.

Each leaf of the reference's parameter tree is saved under its tree path
(``stack/attn/wq``, ``embed``, …; layer stacks stacked on their leading
axes) in one ``params.npz``, and a sidecar ``meta.json`` records ``step``,
each leaf's shape and dtype (``leaves``) and ``extra``. A checkpoint
written by either package restores in the other: the port maps its
per-layer parameter names to the tree with ``carry.model_params_to_numpy``
and back with ``carry.model_params_from_numpy``.

A bf16 leaf is written as the reference writes it, as its raw 2-byte bits
(numpy ``V2``), with ``"dtype": "bfloat16"`` in ``meta.json``, and is read
back by that dtype. (The reference's ``restore`` cannot cast such a leaf,
numpy having no bfloat16.)

``restore(..., shardings=specs, mesh=mesh)`` is the reference's
``shardings`` (a ``jax.device_put`` of each leaf onto a mesh): every rank
reads the whole checkpoint and keeps its shard of each leaf, placed by its
spec (``launch/sharding.py``), with nothing sent between ranks.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import spmd
from repro_torch.carry import (
    BF16_BITS,
    bf16_from_bits,
    model_params_from_numpy,
    model_params_to_numpy,
    tensor_to_numpy,
)


def _flatten(tree, prefix: str = "") -> dict:
    """"a/b/c" -> leaf of a nested dict, keys in the order
    ``jax.tree_util`` flattens a dict (sorted)."""
    flat = {}
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            flat.update(_flatten(tree[key], path + "/"))
        else:
            flat[path] = tree[key]
    return flat


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == BF16_BITS else str(a.dtype)


def save(path: str, params, step: int = 0,
         extra: Optional[dict] = None) -> None:
    """Write ``params`` to the directory ``path``: a ``Model`` (its
    weights, in the reference's tree), or a nested dict of tensors or
    numpy arrays in the reference's layout. DTensors (a model on a mesh)
    are gathered whole on every rank, and rank 0 writes."""
    if isinstance(params, torch.nn.Module):
        params = model_params_to_numpy(params.cfg, params)
    arrays = {k: tensor_to_numpy(v) if isinstance(v, torch.Tensor)
              else np.asarray(v) for k, v in _flatten(params).items()}
    if dist.is_initialized() and dist.get_rank() != 0:
        return                      # every rank gathered; rank 0 writes
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **arrays)
    meta = {
        "step": step,
        "leaves": {
            k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
            for k, v in arrays.items()
        },
        "extra": extra or {},
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def restore(path: str, like=None, shardings=None, mesh=None):
    """Read the checkpoint at ``path``. Returns (restored, step).

    ``like`` None: ``restored`` is a dict of tree path -> host tensor in
    the dtype ``meta.json`` records (bf16 leaves from their bits). ``like``
    a ``Model`` (not yet on a mesh; on ``meta`` with ``shardings``): its
    weights are loaded from the checkpoint, in place and cast to each
    parameter's dtype, and ``restored`` is the model. ``like`` a nested
    dict of tensors: ``restored`` has its structure, each leaf cast to
    the matching leaf's dtype and device.

    ``shardings`` (with ``mesh``, a ``DeviceMesh``): the specs of the
    leaves, by parameter name for a ``Model`` (``param_specs``), by tree
    path for a dict; every leaf is then placed on ``mesh`` as a DTensor
    (``spmd.distribute``), one leaf at a time, each cut to this rank's
    shard before the next goes to the device (the mesh's for a
    ``Model``)."""
    if (shardings is None) != (mesh is None):
        raise ValueError("shardings and mesh go together")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "params.npz")) as data:
        flat = {}
        for key in data.files:
            a = data[key]
            if meta["leaves"][key]["dtype"] == "bfloat16":
                flat[key] = bf16_from_bits(a)
            else:
                flat[key] = torch.from_numpy(np.array(a))
    if like is None:
        return flat, meta["step"]
    if isinstance(like, torch.nn.Module):
        tree = _unflatten({k: tensor_to_numpy(flat.pop(k))
                           for k in list(flat)})
        if shardings is not None:
            # one leaf at a time onto the mesh's device, cut to its shard
            state = model_params_from_numpy(like.cfg, tree, device="cpu")
            spmd.place(like, mesh, shardings, state, mesh.device_type)
            return like, meta["step"]
        device = next(like.parameters()).device
        state = model_params_from_numpy(like.cfg, tree, device=device)
        own = like.state_dict()
        like.load_state_dict({k: v.to(own[k].dtype)
                              for k, v in state.items()})
        return like, meta["step"]
    restored = {}
    for k, leaf in _flatten(like).items():
        t = flat.pop(k).to(dtype=leaf.dtype, device=leaf.device)
        restored[k] = t if shardings is None else \
            spmd.distribute(t, mesh, shardings[k])
    return _unflatten(restored), meta["step"]
