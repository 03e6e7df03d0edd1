"""Train step: loss and gradient, microbatch accumulation and AdamW,
counterpart of ``repro/train/step.py``.

PyTorch runs eagerly, so there is no ``jit`` and no donation: the step
updates the state's params and moments in place (``optim/adamw.py`` says
why) and returns the same state with its step advanced. The gradient is
taken by ``torch.autograd.grad`` with respect to detached leaves that
share the params' storage, so the params themselves never require grad.
ZeRO-1 (``zero1=True``), ``jit_train_step``, ``state_shardings`` and
``_match_sharding`` wait for the port of the distribution code.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..optim import (
    OptimizerConfig,
    adamw_init,
    adamw_update,
    tree_leaves,
    tree_map,
)


def init_train_state(gen, init_fn, zero1: bool = False):
    """``{"params": init_fn(gen), "opt": adamw_init(params)}``: the f32
    params double as the master copy."""
    if zero1:
        raise NotImplementedError(
            "ZeRO-1 train states (bf16 compute params beside an f32 master) "
            "wait for the port of the distribution code")
    params = init_fn(gen)
    return {"params": params, "opt": adamw_init(params)}


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


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                    microbatches: int = 1):
    """loss_fn(params, batch) -> (loss, metrics). Returns
    ``step(state, batch) -> (state, metrics)``, which updates ``state`` in
    place. With ``microbatches`` > 1 the batch's leading axis is cut into
    that many equal microbatches; their gradients are summed in f32 and
    divided by the count, one microbatch's activations live at a time."""

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
        if microbatches > 1:
            loss, metrics, grads = accumulate(state["params"], batch)
        else:
            loss, metrics, grads = _grads_of(loss_fn, state["params"], batch)
        params, opt, opt_metrics = adamw_update(
            grads, state["opt"], state["params"], opt_cfg)
        del grads
        state["params"], state["opt"] = params, opt
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["total_loss"] = loss
        return state, metrics

    return train_step
