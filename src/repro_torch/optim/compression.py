"""Error-feedback gradient compression for the cross-pod all-reduce,
counterpart of ``repro/optim/compression.py``.

Compressing only the `pod`-axis gradient reduce cuts the bytes that
cross the slowest links while the intra-pod reduces stay exact. Scheme:
per-tensor symmetric int8 quantization with error feedback — the
quantization residual is carried beside the optimizer state and added to
the next step's gradient, so the accumulated error stays bounded
(Karimireddy et al. 2019).

The reference runs ``pod_allreduce_compressed`` under ``shard_map`` with
the gradients' own partition specs; here each rank holds its local
shard and the collectives run eagerly on the process group of the
mesh's `pod` dimension. ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .adamw import tree_leaves, tree_map


def quantize_int8(x):
    """Symmetric per-tensor int8. Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_with_feedback(g, err):
    """Returns (q, scale, new_err). err is the running residual."""
    corrected = g.to(torch.float32) + err
    q, scale = quantize_int8(corrected)
    new_err = corrected - dequantize_int8(q, scale)
    return q, scale, new_err


def ef_state_init(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _reduce_leaf(g, err, group):
    corrected = g.to(torch.float32) + err
    # Shared global scale: one scalar all-reduce (MAX) lets every peer
    # quantize onto the SAME grid, so sum_i q_i * s dequantizes the int32
    # sum exactly up to rounding (<= s/2 per peer). Only the int8 payload,
    # summed as int32, crosses the slow inter-pod link.
    amax = torch.max(torch.abs(corrected))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    new_err = corrected - q.to(torch.float32) * scale
    summed = q.to(torch.int32)
    dist.all_reduce(summed, group=group)
    n = float(dist.get_world_size(group))
    out = summed.to(torch.float32) * scale / n
    return out.to(g.dtype), new_err


def _over_pod(fn, mesh, specs, *trees):
    """``fn(group, *local leaves) -> tuple of tensors`` over the leaves of
    ``trees`` on the mesh's `pod` group; returns one tree per output. A
    leaf is this rank's shard, laid out by its placements in ``specs``: a
    plain tensor, or a DTensor with those placements (its local shard is
    reduced and the results are DTensors with the same placements)."""
    group = mesh.get_group("pod")
    leaf_specs = []
    tree_map(lambda _, s: leaf_specs.append(tuple(s)), trees[0], specs)
    outs = []
    for spec, *leaves in zip(leaf_specs, *map(tree_leaves, trees)):
        like = leaves[0]
        if not isinstance(like, DTensor):
            outs.append(fn(group, *leaves))
            continue
        if tuple(like.placements) != spec:
            raise ValueError(f"leaf placed as {like.placements}, specs "
                             f"say {spec}")
        outs.append(tuple(
            DTensor.from_local(o, mesh, like.placements, run_check=False,
                               shape=like.shape, stride=like.stride())
            for o in fn(group, *(x.to_local() for x in leaves))))
    trees_out = []
    for i in range(len(outs[0]) if outs else 0):
        it = iter(o[i] for o in outs)
        trees_out.append(tree_map(lambda _: next(it), trees[0]))
    return trees_out


def pod_allreduce_compressed(grads, err_state, mesh, specs):
    """Mean-reduce grads over the `pod` mesh axis with int8 + EF.

    specs: tree of placements (``tree_shardings``) matching how grads are
    sharded over the non-pod axes; on entry each pod holds its own
    pod-local gradient, on return every pod holds the mean. Returns
    ``(grads, new_err_state)``."""
    return tuple(_over_pod(lambda grp, g, e: _reduce_leaf(g, e, grp), mesh,
                           specs, grads, err_state))


def pod_allreduce_mean(grads, mesh, specs):
    """Exact (uncompressed) pod mean-reduce, the same structure — the
    baseline the compression is measured against."""
    def mean(grp, g):
        s = g.clone()
        dist.all_reduce(s, group=grp)
        return (s / dist.get_world_size(grp),)

    return _over_pod(mean, mesh, specs, grads)[0]
