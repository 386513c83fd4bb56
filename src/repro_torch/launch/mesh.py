"""Mesh construction and axis helpers over a ``torch.distributed`` ``DeviceMesh``.

The reference's ``repro/launch/mesh.py``. Single pod: (data=16, model=16);
multi-pod: (pod=2, data=16, model=16), "pod" the slowest axis: data
parallelism spans pods, tensor and expert parallelism stay inside the fast
domain. ``REPRO_DEBUG_MESH`` (e.g. ``2x2`` or ``2x2x4``) picks a small mesh,
as in the reference.

A mesh needs a process group first (``torch.distributed.init_process_group``
with this rank's address, world size and rank): ``init_device_mesh`` builds
one sub-group per axis over it. The helpers read only
``mesh.mesh_dim_names`` and ``mesh.size(dim)``, so anything that has those
two (a stand-in in tests) serves them.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

__all__ = ["make_mesh", "make_production_mesh", "data_axes", "model_axis", "mesh_tp",
           "axis_size"]


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group (``device_type`` ``"cuda"`` unless the caller says ``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in length")
    return init_device_mesh(device_type, tuple(int(n) for n in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    debug = os.environ.get("REPRO_DEBUG_MESH")  # e.g. "2x2" or "2x2x4" (tests)
    if debug:
        shape = tuple(int(x) for x in debug.split("x"))
        return make_mesh(shape, ("pod", "data", "model")[-len(shape):], device_type)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def axis_size(mesh, name: str) -> int:
    """The number of ranks along the mesh axis ``name``."""
    return int(mesh.size(list(mesh.mesh_dim_names).index(name)))


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes the global batch shards over (pod included when present)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


def mesh_tp(mesh) -> int:
    """Tensor-parallel degree (size of the model axis)."""
    return axis_size(mesh, "model")
