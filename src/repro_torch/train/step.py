"""Train step: loss and gradient, microbatch accumulation and AdamW,
counterpart of ``repro/train/step.py``.

PyTorch runs eagerly, so there is no ``jit`` and no donation: the step
updates the state's params and moments in place (``optim/adamw.py`` says
why) and returns the same state with its step advanced. The gradient is
taken by ``torch.autograd.grad`` with respect to detached leaves that
share the params' storage, so the params themselves never require grad.

Under a mesh (``distributed.use_mesh``; ``jit_train_step`` wraps a step
in one) the state's leaves are DTensors placed by ``state_shardings``,
and the forward and backward never see one: the kernels take plain
contiguous tensors. Each step gathers the compute params whole on every
rank, once (``full_tensor``), runs this rank's shard of the batch, and
counts the local gradients as ``Partial`` over the batch axes:
redistributing them onto the master's placements is the reduce-scatter
of the reference's ``_match_sharding``. AdamW then updates each rank's
shard. The ``model`` axis is a storage axis here: params and state shard
over it by the rules, compute is data-parallel on gathered params (the
reference's GSPMD gathers per layer and runs tensor- and
expert-parallel compute).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..distributed.api import (
    axis_sizes,
    batch_over_model,
    current_mesh,
    logical_to_physical,
    use_mesh,
)
from ..distributed.sharding import (
    ShardingOptions,
    distribute_tree,
    tree_shardings,
)
from ..optim import (
    OptimizerConfig,
    adamw_init,
    adamw_update,
    tree_leaves,
    tree_map,
)


def init_train_state(gen, init_fn, zero1: bool = False):
    """Default (ZeRO-3/FSDP): ``{"params": init_fn(gen), "opt":
    adamw_init(params)}``, the f32 params double as the master copy and
    shard over (data x model) under a mesh.

    ``zero1=True`` (ZeRO-1/2): bf16 compute params (sharded over model
    only) beside the f32 ``master``, from which ``opt`` is initialised;
    master and moments shard over (data x model)."""
    params = init_fn(gen)
    if not zero1:
        return {"params": params, "opt": adamw_init(params)}

    def to_bf16(p):
        return p.to(torch.bfloat16) if p.is_floating_point() else p

    return {"params": tree_map(to_bf16, params), "master": params,
            "opt": adamw_init(params)}


def _grads_of(loss_fn, params, batch):
    """(loss, detached metrics, grads) of loss_fn at params; grads are f32
    tensors in the params' structure."""
    wrt = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()),
                   params)
    with torch.enable_grad():
        loss, metrics = loss_fn(wrt, batch)
        leaves = tree_leaves(wrt)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p, dtype=torch.float32) if g is None
             else g.float() for p, g in zip(leaves, grads)]
    it = iter(grads)
    return (loss.detach(), tree_map(lambda v: v.detach(), metrics),
            tree_map(lambda _: next(it), params))


def _aggregate(per_mb, name=None):
    """Per-microbatch metrics -> one: the max over microbatches for
    ``max_*`` leaves (e.g. the Soft-MoE ``max_combine`` collapse probe),
    the mean for the rest; keyed per leaf, so nested dicts aggregate too."""
    first = per_mb[0]
    if isinstance(first, dict):
        return {k: _aggregate([m[k] for m in per_mb], k) for k in first}
    stacked = torch.stack([torch.as_tensor(v) for v in per_mb])
    if name is not None and str(name).startswith("max_"):
        return stacked.max(dim=0).values
    return stacked.mean(dim=0)


def _batch_dims(mesh):
    """(indices of the mesh dimensions the batch is split over, the
    number of batch shards)."""
    ba = logical_to_physical(mesh, "batch")
    dims = [mesh.mesh_dim_names.index(a)
            for a in ((ba,) if isinstance(ba, str) else ba)]
    return dims, math.prod(mesh.shape[d] for d in dims)


def _local_batch(mesh, batch):
    """This rank's shard of the global batch: the leading axis cut over
    the batch dimensions of the mesh, in mesh order."""
    dims, n = _batch_dims(mesh)
    coord = mesh.get_coordinate()
    idx = 0
    for d in dims:
        idx = idx * mesh.shape[d] + coord[d]
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split over {n} batch shards")
        m = v.shape[0] // n
        out[k] = v[idx * m:(idx + 1) * m]
    return out


def _reduce_metrics(mesh, metrics, name=None):
    """The batch shards' metrics -> the global batch's: the max for
    ``max_*`` leaves, the mean for the rest."""
    if isinstance(metrics, dict):
        return {k: _reduce_metrics(mesh, v, k) for k, v in metrics.items()}
    is_max = name is not None and str(name).startswith("max_")
    out = (metrics.detach().clone() if torch.is_tensor(metrics)
           else torch.tensor(metrics, device=mesh.device_type))
    dims, n = _batch_dims(mesh)
    for d in dims:
        dist.all_reduce(out, op=dist.ReduceOp.MAX if is_max
                        else dist.ReduceOp.SUM, group=mesh.get_group(d))
    return out if is_max else out / n


def _gathered(tree):
    """The compute params, whole on every rank: plain tensors."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                    microbatches: int = 1):
    """loss_fn(params, batch) -> (loss, metrics). Returns
    ``step(state, batch) -> (state, metrics)``, which updates ``state`` in
    place. With ``microbatches`` > 1 the batch's leading axis is cut into
    that many equal microbatches; their gradients are summed in f32 and
    divided by the count, one microbatch's activations live at a time.
    A ZeRO-1 state (``"master"`` present) updates the f32 master and casts
    it back into the compute params. Under a mesh the batch is the global
    one, the same on every rank; each rank runs its shard of it."""

    def accumulate(params, batch):
        def part(x, i):
            n = x.shape[0] // microbatches
            return x[i * n:(i + 1) * n]

        grads, loss_sum, per_mb = None, 0, []
        for i in range(microbatches):
            mb = {k: part(v, i) for k, v in batch.items()}
            loss, metrics, g = _grads_of(loss_fn, params, mb)
            if grads is None:
                grads = tree_map(torch.zeros_like, g)
            for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                acc.add_(gi)
            del g
            loss_sum = loss_sum + loss
            per_mb.append(metrics)
        for acc in tree_leaves(grads):
            acc.div_(microbatches)
        return loss_sum / microbatches, _aggregate(per_mb), grads

    def train_step(state, batch):
        mesh = current_mesh()
        params = state["params"]
        if mesh is not None:
            params, batch = _gathered(params), _local_batch(mesh, batch)
        if microbatches > 1:
            loss, metrics, grads = accumulate(params, batch)
        else:
            loss, metrics, grads = _grads_of(loss_fn, params, batch)
        del params
        if mesh is not None:
            loss = _reduce_metrics(mesh, loss)
            metrics = _reduce_metrics(mesh, metrics)
        master = state.get("master", state["params"])
        grads = _match_sharding(grads, master)
        new_master, opt, opt_metrics = adamw_update(
            grads, state["opt"], master, opt_cfg)
        del grads
        # AdamW updated the moments in place; the step counter advances in
        # place too, so every leaf of the state keeps its storage
        state["opt"]["step"].copy_(opt["step"])
        if "master" in state:  # ZeRO-1: cast the master back into the
            # compute params; under a mesh the master shards over data and
            # the compute params do not, so the cast (bf16) is gathered
            # over data: one all-gather a step
            for p, m in zip(tree_leaves(state["params"]),
                            tree_leaves(new_master)):
                if not p.is_floating_point():
                    continue
                m = m.to(p.dtype)
                if isinstance(p, DTensor):
                    m = m.redistribute(p.device_mesh, p.placements)
                    p, m = p.to_local(), m.to_local()
                p.copy_(m)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["total_loss"] = loss
        return state, metrics

    return train_step


def _match_sharding(grads, master):
    """Pin grads to the master's placements. Under a mesh each rank's
    gradient (of the whole params, from its batch shard) counts as
    ``Partial`` over the batch axes; redistributing it onto the master's
    (data x model) placements lowers to a reduce-scatter (each data shard
    only needs its slice), and dividing by the number of batch shards
    makes the sum a mean. Without a mesh the grads stay as they are."""
    mesh = current_mesh()
    if mesh is None:
        return grads
    dims, n = _batch_dims(mesh)
    partial = tuple(Partial() if i in dims else Replicate()
                    for i in range(mesh.ndim))

    def one(g, m):
        out = DTensor.from_local(g, mesh, partial, run_check=False)
        out = out.redistribute(mesh, m.placements)
        out.to_local().div_(n)
        return out

    return tree_map(one, grads, master)


def jit_train_step(train_step, mesh, state_shardings):
    """The step under ``mesh``, counterpart of the reference's ``jit``
    with pinned shardings: places the state's leaves onto
    ``state_shardings`` (leaves already placed stay as they are) and runs
    ``train_step`` with ``mesh`` current, keeping the caller's
    ``dp_over_model`` flag. There is no donation to ask for: the step
    updates the state in place."""

    def step(state, batch):
        state = distribute_tree(mesh, state, state_shardings)
        with use_mesh(mesh, dp_over_model=batch_over_model()):
            return train_step(state, batch)

    return step


def state_shardings(mesh, state, opts=None):
    """Shard optimizer moments exactly like their params (FSDP included).
    ZeRO-1 states ('master' present): compute params shard over model
    only; master + moments keep the full (data x model) sharding. The
    step counter is replicated. Leaves are DTensor placements."""
    opts = opts or ShardingOptions()
    rep = (Replicate(),) * len(axis_sizes(mesh))
    if "master" in state:
        compute_sh = tree_shardings(
            mesh, state["params"], dataclasses.replace(opts, fsdp=False))
        master_sh = tree_shardings(mesh, state["master"], opts)
        return {
            "params": compute_sh,
            "master": master_sh,
            "opt": {"mu": master_sh, "nu": master_sh, "step": rep},
        }
    param_sh = tree_shardings(mesh, state["params"], opts)
    return {
        "params": param_sh,
        "opt": {"mu": param_sh, "nu": param_sh, "step": rep},
    }
