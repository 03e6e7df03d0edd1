"""Counterpart of ``repro/distributed/compat.py``.

The reference shims three jax APIs that drifted between versions. Only
``axis_size`` has a torch counterpart: the world size of the process
group of one mesh dimension. ``shard_map`` has none (the port's
collectives call ``torch.distributed`` on the dimension's group
directly, eagerly), and ``cost_analysis_dict`` reads a compiled XLA
program, which belongs to the roofline slice.
"""
from __future__ import annotations

import torch.distributed as dist

from .api import current_mesh


def axis_size(axis_name: str, mesh=None) -> int:
    """Size of a named mesh axis: the world size of its process group on
    ``mesh`` (the current mesh when None)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError(f"axis_size({axis_name!r}) needs a mesh")
    return dist.get_world_size(mesh.get_group(axis_name))
