"""The collectives a program emits, counterpart of
``repro/roofline/hlo_parse.py``.

The reference compiles a cell and reads its collectives from the
optimized HLO text, multiplying loop bodies by their trip counts. The
port runs eagerly, so it records them instead: ``record_collectives()``
is a ``TorchDispatchMode`` that sees every ``_c10d_functional`` and
``c10d`` collective the program emits while it runs (on meta tensors
under a fake process group in the dry-run, ``launch/dryrun.py``), each
counted every time it is emitted, so a layer loop counts as many times
as it runs. Each becomes a ``Collective`` with

  * its kind, in the reference's names (``all-gather``, ...);
  * its bytes, the size of its result as the reference reads the
    instruction's result shape (the gathered tensor of an all-gather,
    the shard of a reduce-scatter, the buffer of an in-place ``c10d``
    op);
  * the size of its group, from the group's ranks, and the ring
    algorithm factor that follows from it;
  * ``crosses_pod``, whether the group holds ranks of more than one pod
    (``rank // pod_size``), so its bytes are priced at the inter-node
    rate.

``cpu_upcast_correction`` has no counterpart: there is no XLA-CPU
program whose bf16 dots were legalized to f32.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

# op name (without overload) -> the reference's collective kind
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    "send": "collective-permute",
    "recv_": "collective-permute",
}


@dataclass
class Collective:
    kind: str
    bytes: int
    group_size: int
    crosses_pod: bool
    count: int = 1

    def alg_factor(self) -> float:
        n = max(self.group_size, 2)
        if self.kind == "all-reduce":
            return 2.0 * (n - 1) / n
        if self.kind in ("all-gather", "reduce-scatter"):
            return (n - 1) / n
        return 1.0


@dataclass
class ModuleCollectives:
    collectives: List[Collective] = field(default_factory=list)

    def weighted_ici_bytes(self) -> float:
        """Ring-weighted bytes of the collectives inside one pod (the
        NVLink term)."""
        return sum(
            c.bytes * c.count * c.alg_factor()
            for c in self.collectives
            if not c.crosses_pod
        )

    def weighted_pod_bytes(self) -> float:
        """Ring-weighted bytes of the collectives whose group spans pods
        (the inter-node term)."""
        return sum(
            c.bytes * c.count * c.alg_factor()
            for c in self.collectives
            if c.crosses_pod
        )

    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for c in self.collectives:
            out[c.kind] = out.get(c.kind, 0) + c.bytes * c.count
        return out

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for c in self.collectives:
            out[c.kind] = out.get(c.kind, 0) + c.count
        return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_ranks(func, args, kwargs) -> List[int]:
    """Global ranks of the group a collective runs on: the group name (the
    last argument) of a functional collective, the process group among
    the arguments of a ``c10d`` op."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    if func.namespace == "_c10d_functional":
        pg = _resolve_process_group(kwargs.get("group_name", args[-1]))
        return dist.get_process_group_ranks(pg)
    for a in list(args) + list(kwargs.values()):
        if (isinstance(a, torch.ScriptObject)
                and a._type().qualified_name().endswith("c10d.ProcessGroup")):
            return dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
    raise ValueError(f"no process group among the arguments of {func}")


class record_collectives(TorchDispatchMode):
    """``with record_collectives(pod_size) as rec: program()`` leaves
    every collective the program emitted in ``rec.module``, a
    ``ModuleCollectives`` (identical ones merged into one entry with its
    count). ``pod_size`` is the ranks of one pod (None: one pod)."""

    def __init__(self, pod_size: Optional[int] = None):
        super().__init__()
        self.pod_size = pod_size
        self._entries: Dict[tuple, Collective] = {}
        self.module = ModuleCollectives()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = (_KINDS.get(func._opname)
                if func.namespace in ("_c10d_functional", "c10d") else None)
        if kind is not None:
            ranks = _group_ranks(func, args, kwargs)
            crosses = bool(self.pod_size) and (
                len({r // self.pod_size for r in ranks}) > 1)
            # functional ops return their result; c10d's in-place ops
            # write their first argument
            nbytes = _nbytes(out if func.namespace == "_c10d_functional"
                             else args[0])
            key = (kind, nbytes, len(ranks), crosses)
            if key in self._entries:
                self._entries[key].count += 1
            else:
                c = Collective(kind, nbytes, len(ranks), crosses)
                self._entries[key] = c
                self.module.collectives.append(c)
        return out
