"""Mesh construction, counterpart of ``repro/launch/mesh.py``.

Single pod: (data=16, model=16) = 256 devices. Multi-pod: (pod=2,
data=16, model=16) = 512; the `pod` axis carries only data parallelism
(gradient reduces), matching the slower inter-pod links.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the default
process group. Where JAX sees its devices implicitly, torch needs a
process group first: when none exists, ``make_mesh`` starts one — from
the environment that ``torchrun`` sets (``WORLD_SIZE`` and the rest),
else a group of one rank on an in-memory store. NCCL on the card, gloo
on the CPU (``device="cpu"``); a group that fails to start raises.
Functions, never module-level constants, so importing this module
touches no device and no process group.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..layers.common import resolve_device


def _process_group(device) -> torch.device:
    """The default process group, started when there is none."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:  # torchrun: env:// rendezvous
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return dev


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device="cuda"):
    dev = _process_group(device)
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a {tuple(shape)} mesh over {tuple(axes)} needs "
                         f"{n} ranks; the process group has {world}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(model: Optional[int] = None, device="cuda"):
    """Smallest valid (data, model) mesh over every rank of the process
    group (one rank when none was started)."""
    _process_group(device)
    n = dist.get_world_size()
    model = model or 1
    if n % model:
        raise ValueError(f"model={model} does not divide {n} ranks")
    return make_mesh((n // model, model), ("data", "model"), device)
