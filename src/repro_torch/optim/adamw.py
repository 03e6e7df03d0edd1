"""AdamW with f32 master params and global-norm clipping, counterpart of
``repro/optim/adamw.py``.

The arithmetic is the JAX function's, op for op in f32 tensors: the
moments, the bias corrections ``1 - b ** step`` and the learning-rate
schedule are f32 tensor ops, not Python doubles. Where JAX builds new
params and moments, the port updates them in place under
``torch.no_grad()``, one leaf at a time (and ``clip_by_global_norm``
scales the gradients in place): a functional update holds a second copy
of params, mu and nu at once, ~41 GiB more at soft-moe-b/16-128e, which
does not fit the 80 GB card beside the first. Leaves are the tensors of
nested dicts and lists, in insertion order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 1e-3
    schedule: str = "rsqrt"  # "rsqrt" | "cosine" | "linear" | "constant"
    warmup_steps: int = 10_000
    total_steps: int = 300_000
    cooldown_steps: int = 50_000  # paper: linear cooldown tail
    timescale: float = 1e5  # rsqrt timescale (paper App. E)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    grad_clip_norm: float = 1.0


def tree_leaves(tree):
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def adamw_init(params):
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {
        "mu": tree_map(torch.zeros_like, params),
        "nu": tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in f32, summed leaf by
    leaf from 0 as the JAX function's Python ``sum``."""
    total = 0
    for x in tree_leaves(tree):
        x = x.float()
        total = total + torch.sum(x * x)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm``; returns ``(grads, norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads, norm


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptimizerConfig, lr=None):
    """One AdamW step, in place: ``params`` and the moments are updated
    leaf by leaf (``grads`` are clipped in place first). Returns
    ``(params, {"mu", "nu", "step"}, {"grad_norm", "lr"})`` with the
    step advanced, as the JAX function returns its new trees."""
    step = opt_state["step"] + 1
    lr = schedule_lr(cfg, step) if lr is None else lr
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    s = step.float()
    bc1 = 1 - torch.pow(b1, s)
    bc2 = 1 - torch.pow(b2, s)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(opt_state["mu"]),
                          tree_leaves(opt_state["nu"]), tree_leaves(params)):
        g = g.float()
        m.mul_(b1).add_(g * (1 - b1))          # b1 m + (1 - b1) g
        v.mul_(b2).add_((g * g).mul_(1 - b2))  # b2 v + (1 - b2) g^2
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        delta.add_(p * cfg.weight_decay)       # mhat / (sqrt(vhat) + eps) + wd p
        p.sub_(delta.mul_(lr))
    new_state = {"mu": opt_state["mu"], "nu": opt_state["nu"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def schedule_lr(cfg: OptimizerConfig, step):
    """Paper setup: inverse-sqrt decay with linear warmup and a linear
    cooldown tail (section 3.3 / App. E); cosine, linear and constant too.
    ``step`` is an int tensor; the result is an f32 tensor."""
    s = torch.as_tensor(step).float()
    f32 = dict(dtype=torch.float32, device=s.device)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "rsqrt":
        ts = torch.tensor(cfg.timescale, **f32)
        base = torch.sqrt(ts) / torch.sqrt(torch.clamp(s, min=cfg.timescale))
    elif cfg.schedule == "cosine":
        frac = torch.clamp(s / cfg.total_steps, 0.0, 1.0)
        base = 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        base = 1.0 - torch.clamp(s / cfg.total_steps, 0.0, 1.0)
    else:
        base = torch.ones((), **f32)
    # linear cooldown tail to zero over the last `cooldown_steps`
    tail = torch.clamp((cfg.total_steps - s) / max(cfg.cooldown_steps, 1),
                       0.0, 1.0)
    return cfg.peak_lr * warm * base * tail
