"""Soft-MoE ops on the kernels, forward and backward: counterpart of
``repro/kernels/ops.py``.

``routing_health`` runs K6, the telemetry reductions, with no gradient.
``soft_moe_routing`` runs K1 (dispatched slots plus both softmax
directions' stats from one logits pass); ``soft_moe_combine`` runs K2
with K1's saved combine stats, or K3 (online softmax) without them. Each
is a ``torch.autograd.Function`` (the JAX package's ``custom_vjp``s)
whose backward runs the flash-style kernels: K4 for the routing, K5 for
either combine. The weights are recomputed tile-wise from the saved
``(max, denom)`` residuals, so no (m x S) tensor exists in device memory
in either direction. Residuals per layer:

  routing: (x, phi_n, slots, d_mx, d_den)
  combine: (x, phi_n, ys, c_mx, c_den, y)

The stats outputs carry no gradient: the softmax VJP's normalizer term is
carried by the -sigma / -rho row corrections inside the backward kernels,
as flash attention treats its saved logsumexp, so their cotangents are
zero by construction and the Functions mark them non-differentiable. The
Functions call the raw wrappers on detached tensors and make incoming
gradients contiguous (they arrive through reshapes and permutes); on CPU
tensors the wrappers run the plain versions, on CUDA tensors the kernels.

Per-sequence invariant: the batch axis is a pure grid axis. Every softmax
stat reduces within one row, so row i of a batched call equals a batch-1
call of that row, bitwise (``kernels/ref.py`` is the single-sequence
oracle); dPhi_n sums the rows' own partials in row order.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from . import ref
from .soft_moe_kernels import (
    combine_apply,
    combine_bwd,
    combine_online,
    dispatch_bwd,
    routing_fwd,
)
from .soft_moe_kernels import routing_health as _routing_health
from .tuning import KernelConfig


class _Routing(torch.autograd.Function):
    """K1 forward, K4 backward: (slots, d_mx, d_den, c_mx, c_den)."""

    @staticmethod
    def forward(ctx, x, phi_n, cfg):
        slots, (d_mx, d_den), (c_mx, c_den) = routing_fwd(
            x.detach(), phi_n.detach(), cfg)
        ctx.cfg = cfg
        ctx.save_for_backward(x, phi_n, slots, d_mx, d_den)
        ctx.mark_non_differentiable(d_mx, d_den, c_mx, c_den)
        return slots, d_mx, d_den, c_mx, c_den

    @staticmethod
    @once_differentiable
    def backward(ctx, g_slots, *_stats):
        x, phi_n, slots, d_mx, d_den = ctx.saved_tensors
        dx, dphi = dispatch_bwd(x, phi_n, g_slots.contiguous(),
                                (d_mx, d_den), slots, ctx.cfg)
        return dx, dphi, None


class _CombineStats(torch.autograd.Function):
    """K2 forward (stats given), K5 backward."""

    @staticmethod
    def forward(ctx, x, phi_n, ys, c_mx, c_den, cfg):
        y = combine_apply(x.detach(), phi_n.detach(), ys.detach(),
                          (c_mx.detach(), c_den.detach()), cfg)
        ctx.cfg = cfg
        ctx.save_for_backward(x, phi_n, ys, c_mx, c_den, y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, phi_n, ys, c_mx, c_den, y = ctx.saved_tensors
        dx, dphi, dys = combine_bwd(x, phi_n, ys, g.contiguous(),
                                    (c_mx, c_den), y, ctx.cfg)
        return dx, dphi, dys, None, None, None


class _CombineOnline(torch.autograd.Function):
    """K3 forward (online softmax; its stats are saved), K5 backward."""

    @staticmethod
    def forward(ctx, x, phi_n, ys, cfg):
        y, (c_mx, c_den) = combine_online(x.detach(), phi_n.detach(),
                                          ys.detach(), cfg)
        ctx.cfg = cfg
        ctx.save_for_backward(x, phi_n, ys, c_mx, c_den, y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, phi_n, ys, c_mx, c_den, y = ctx.saved_tensors
        dx, dphi, dys = combine_bwd(x, phi_n, ys, g.contiguous(),
                                    (c_mx, c_den), y, ctx.cfg)
        return dx, dphi, dys, None


def soft_moe_routing(x, phi_n, config: Optional[KernelConfig] = None, *,
                     with_d_stats: bool = False):
    """x: (b, m, d); phi_n: (d, S) pre-normalized.

    Returns ``(slots, (c_mx, c_den))``: the dispatched slots (b, S, d) and
    the combine-direction softmax stats (each (b, m)) from the same logits
    pass; hand the stats to :func:`soft_moe_combine` to skip its online
    rescan, and derive the ``max_combine`` metric as ``1 / c_den``.
    ``with_d_stats=True`` also returns the per-slot dispatch stats:
    ``(slots, (d_mx, d_den), (c_mx, c_den))``. The slots are
    differentiable in x and phi_n (K4); the stats carry no gradient.
    ``config`` None means the default tile policy
    (``tuning.default_config``), which each wrapper derives alike."""
    slots, d_mx, d_den, c_mx, c_den = _Routing.apply(x, phi_n, config)
    if with_d_stats:
        return slots, (d_mx, d_den), (c_mx, c_den)
    return slots, (c_mx, c_den)


def routing_health(x, phi_n, d_stats, c_stats,
                   config: Optional[KernelConfig] = None):
    """The Fig. 9 routing-health reductions from the saved softmax stats
    (K6): ``(disp_entropy (b, S), importance (b, S), comb_entropy (b, m),
    token_contrib (b, m))``, f32. Telemetry carries no gradient (the JAX
    function stops it at every input), so the kernel runs on detached
    tensors; ``core.inspection.routing_health_from_stats`` is its chunked
    plain-torch twin."""
    return _routing_health(x.detach(), phi_n.detach(),
                           tuple(t.detach() for t in d_stats),
                           tuple(t.detach() for t in c_stats), config)


def soft_moe_dispatch(x, phi_n, config: Optional[KernelConfig] = None):
    """x: (b, m, d); phi_n: (d, S) pre-normalized -> slots (b, S, d)."""
    return soft_moe_routing(x, phi_n, config)[0]


def soft_moe_combine(x, phi_n, ys, c_stats=None,
                     config: Optional[KernelConfig] = None):
    """x: (b, m, d); phi_n: (d, S); ys: (b, S, d) -> y (b, m, d),
    differentiable in x, phi_n and ys (K5).

    ``c_stats``: the per-token (max, denom) from :func:`soft_moe_routing`
    (K2, no online rescan). Without it the kernel derives its own (K3)."""
    if c_stats is None:
        return _CombineOnline.apply(x, phi_n, ys, config)
    return _CombineStats.apply(x, phi_n, ys, c_stats[0], c_stats[1], config)


def normalized_phi(phi, scale):
    """phi: (d, n, p) -> (d, n*p) pre-normalized (O(d S), done outside the
    kernels in plain torch, so autograd carries dPhi_n to phi and scale;
    X is normalized inside them)."""
    return ref.normalized_phi(phi.reshape(phi.shape[0], -1), scale)
