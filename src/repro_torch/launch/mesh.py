"""The production mesh: the port of ``repro/launch/mesh.py``.

A ``torch.distributed.device_mesh.DeviceMesh`` over the process group that
is initialised: 16 x 16 = 256 ranks on axes ``("data", "model")``, or
2 x 16 x 16 = 512 on ``("pod", "data", "model")``. Ranks are laid out
row-major, as ``init_device_mesh`` lays them: the ``model`` axis runs over
consecutive ranks. The group comes from the launcher (``torchrun``: NCCL on
cards, gloo on the CPU), or is the fake group that the dry run sets up
(``launch/dryrun.py``). These are functions, not module constants: nothing
here touches process-group state at import.

``AbstractMesh`` names axes and sizes and holds no ranks: the sharding
rules (``launch/sharding.py``) take it or a ``DeviceMesh`` alike, so they
can be read without a process group.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

PROD_SHAPE = (16, 16)
PROD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, with no ranks behind it."""
    sizes: tuple
    names: tuple


def production_shape(multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's shape: 16 x 16, or 2 x 16 x 16."""
    if multi_pod:
        return AbstractMesh(MULTI_POD_SHAPE, MULTI_POD_AXES)
    return AbstractMesh(PROD_SHAPE, PROD_AXES)


def _device_type() -> str:
    backend = dist.get_backend()
    return "cuda" if backend == "nccl" else "cpu"


def make_mesh(sizes: tuple, names: tuple):
    """A ``DeviceMesh`` of ``sizes`` on axes ``names`` over the initialised
    process group, whose world size must be their product."""
    if not dist.is_initialized():
        raise RuntimeError("no process group is initialised: launch under "
                           "torchrun or call init_process_group first")
    world, need = dist.get_world_size(), math.prod(sizes)
    if world != need:
        raise ValueError(f"a {'x'.join(map(str, sizes))} mesh needs a world "
                         f"size of {need}; this one has {world}")
    return init_device_mesh(
        _device_type(), tuple(sizes), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod. Raises,
    naming both sizes, on any other world size."""
    shape = production_shape(multi_pod)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != math.prod(shape.sizes):
        raise ValueError(
            f"the production mesh takes a world size of 256 (16x16) or 512 "
            f"(2x16x16, multi_pod=True); this one has {world}")
    return make_mesh(shape.sizes, shape.names)


def make_host_mesh():
    """A 1 x 1 mesh on ``("data", "model")`` (world size 1)."""
    return make_mesh((1, 1), PROD_AXES)


def axis_names(mesh) -> tuple:
    if isinstance(mesh, AbstractMesh):
        return mesh.names
    return tuple(mesh.mesh_dim_names)


def mesh_sizes(mesh) -> dict:
    """Axis name -> size."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.names, mesh.sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> tuple:
    """Axes that shard the batch: ('pod', 'data') on multi-pod meshes."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def axis_size(mesh, name: str) -> int:
    return mesh_sizes(mesh).get(name, 1)


def mesh_label(mesh) -> str:
    """"16x16", "2x16x16", "1x1", …"""
    return "x".join(str(s) for s in mesh_sizes(mesh).values())
