"""Mesh context and activation sharding constraints, counterpart of
``repro/distributed/api.py``.

Models name *logical* axes (``constrain(x, "batch", None, "model")``);
the mapping to the physical axes of the current mesh lives here, so the
same code runs on a (data, model) mesh, a (pod, data, model) mesh, or
with no mesh at all. The mesh is a ``torch.distributed`` ``DeviceMesh``
with ``mesh_dim_names`` (``launch/mesh.py`` builds one). Eager PyTorch
has no compiler to hint, so ``constrain`` leaves a plain tensor as it
is and redistributes a ``DTensor``; the port's models do not call it
(``models/encdec.py`` says why).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

from torch.distributed.tensor import DTensor, Replicate, Shard

_state = threading.local()


def set_mesh(mesh) -> None:
    _state.mesh = mesh


def current_mesh():
    return getattr(_state, "mesh", None)


def set_batch_over_model(flag: bool) -> None:
    """Pure-DP mode: the logical ``batch`` axis also spans ``model``
    (tensor parallelism off); must match the ``ShardingOptions`` used for
    params and inputs."""
    _state.batch_over_model = flag


def batch_over_model() -> bool:
    return getattr(_state, "batch_over_model", False)


@contextlib.contextmanager
def use_mesh(mesh, *, dp_over_model: bool = False):
    prev = current_mesh()
    prev_bom = batch_over_model()
    set_mesh(mesh)
    set_batch_over_model(dp_over_model)
    try:
        yield mesh
    finally:
        set_mesh(prev)
        set_batch_over_model(prev_bom)


def axis_sizes(mesh) -> dict:
    """{mesh dimension name: its size}."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def logical_to_physical(mesh, name: Optional[str]):
    """Logical activation/param axis -> physical mesh axes (a name, a
    tuple of names, or None)."""
    if name is None:
        return None
    axes = mesh.mesh_dim_names
    if name == "batch":  # data parallel axes (pod x data when multi-pod)
        ba = ("pod", "data") if "pod" in axes else ("data",)
        if batch_over_model():
            ba = ba + ("model",)
        return ba if len(ba) > 1 else ba[0]
    if name == "data":
        return "data"
    if name in ("model", "expert"):  # tensor/expert parallel
        # pure-DP mode: `model` belongs to the batch axes; TP/EP
        # constraints degrade to replicated.
        return None if batch_over_model() else "model"
    if name == "seq":
        # sequence parallelism over `model`, off in pure-DP mode
        return None if batch_over_model() else "model"
    raise ValueError(f"unknown logical axis {name!r}")


def spec(*names) -> tuple:
    """The physical axes of logical ``names`` on the current mesh, one
    entry per tensor dimension: the entries of the reference's
    ``PartitionSpec`` (the empty tuple without a mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    return tuple(logical_to_physical(mesh, n) for n in names)


def phys_size(sizes, phys) -> int:
    """The number of shards of physical axes ``phys`` (a name or a tuple
    of names) on a mesh of ``sizes`` (``axis_sizes``)."""
    return math.prod(sizes[a] for a in ((phys,) if isinstance(phys, str)
                                        else phys))


def placements(mesh, phys_spec) -> tuple:
    """DTensor placements of a physical spec (one entry per tensor
    dimension: a mesh axis name, a tuple of them, or None): ``Shard(dim)``
    on each mesh dimension that shards a tensor dimension, ``Replicate()``
    on the rest. A tensor dimension over several mesh dimensions is split
    in mesh order, as a ``PartitionSpec`` entry ``("pod", "data")`` is."""
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for dim, phys in enumerate(phys_spec):
        if phys is None:
            continue
        for a in (phys,) if isinstance(phys, str) else phys:
            i = mesh.mesh_dim_names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {a!r} shards two tensor "
                                 f"dimensions in {phys_spec}")
            out[i] = Shard(dim)
    return tuple(out)


def constrain(x, *names):
    """Sharding constraint by logical names; a no-op without a mesh and on
    a plain tensor (eager PyTorch has no compiler to hint). A DTensor is
    redistributed onto the named layout. Axes whose dimension is not
    divisible by their mesh-axis size are dropped (e.g. the 196-token ViT
    sequence on a 16-way model axis)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    sizes = axis_sizes(mesh)
    fixed = []
    for ax, name in enumerate(names):
        phys = logical_to_physical(mesh, name)  # raises on unknown names
        if phys is None:  # e.g. "seq" disabled in pure-DP mode
            fixed.append(None)
            continue
        fixed.append(phys if x.shape[ax] % phys_size(sizes, phys) == 0
                     else None)
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(mesh, fixed))


def num_slices(axis: str = "data") -> int:
    mesh = current_mesh()
    if mesh is None:
        return 1
    return axis_sizes(mesh).get(axis, 1)
