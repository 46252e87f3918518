"""Production meshes of H100s (pure functions: importing touches no device
and no process group).

The port's counterpart of the JAX package's ``launch/mesh.py``, with its
chip counts and axis names on the H100's topology:

  pod_32x8:         (data=32, model=8)          = 256 cards
  multipod_2x32x8:  (pod=2, data=32, model=8)   = 512 cards

``model`` is the fastest axis: the eight cards of one NVLink domain (one
HGX board, all to all at 450 GB/s a direction), as the reference puts
``model`` on the ICI ring.  ``data`` spans the boards of a pod and ``pod``
the slowest links, so cross-pod traffic carries only the data-parallel
gradient reduction.

``quad_2x2`` (data=2, model=2) = 4 cards is the port's own, for the
dry-run only: four cards is the most a benchmark cell of this repo may
take, and a (2, 2) mesh uses both of the reference's axes, so FSDP, the
model axis and the sharded MoE's all-gather and mean all act on it.

A ``DeviceMesh`` needs a process group of its size
(``torch.distributed.init_process_group``; the dry-run's is a fake one).
The pure helpers (``dp_axes``, ``mesh_chips``) also take a
:class:`MeshShape`, the duck-typed mesh whose ``.shape`` is a dict of axis
sizes, as the rules do.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.models.sharding import axis_sizes

POD = (32, 8)
POD_AXES = ("data", "model")
MULTIPOD = (2, 32, 8)
MULTIPOD_AXES = ("pod", "data", "model")
QUAD = (2, 2)
QUAD_AXES = ("data", "model")

#: mesh name -> (shape, axis names)
MESHES: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    "quad_2x2": (QUAD, QUAD_AXES),
    "pod_32x8": (POD, POD_AXES),
    "multipod_2x32x8": (MULTIPOD, MULTIPOD_AXES),
}


class MeshShape:
    """A mesh's axis sizes without devices: what the rule functions read."""

    def __init__(self, **axes: int):
        self.shape = dict(axes)

    @classmethod
    def named(cls, name: str) -> "MeshShape":
        shape, axes = MESHES[name]
        return cls(**dict(zip(axes, shape)))


def make_mesh(name: str, device_type: str = "cuda"):
    """The ``DeviceMesh`` of one of :data:`MESHES` over the default
    process group, which must have exactly its size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = MESHES[name]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """pod_32x8 (256 cards), or multipod_2x32x8 (512) with ``multi_pod``;
    the default process group must have that size."""
    import torch.distributed as dist
    name = "multipod_2x32x8" if multi_pod else "pod_32x8"
    n = mesh_chips(MeshShape.named(name))
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(f"mesh {name} needs a process group of {n} ranks"
                           f", found {have}")
    return make_mesh(name, device_type)


def make_host_mesh(axes: Tuple[str, ...] = ("data",),
                   device_type: str = "cuda"):
    """Every rank of the default process group on the first axis, the
    others of size 1 (smoke runs, examples)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    return init_device_mesh(device_type, (n,) + (1,) * (len(axes) - 1),
                            mesh_dim_names=tuple(axes))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def mesh_chips(mesh) -> int:
    n = 1
    for v in axis_sizes(mesh).values():
        n *= v
    return n
