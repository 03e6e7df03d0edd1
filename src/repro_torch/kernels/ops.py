"""Soft-MoE ops on the kernels, forward only: counterpart of
``repro/kernels/ops.py``.

``soft_moe_routing`` runs K1 (dispatched slots plus both softmax
directions' stats from one logits pass); ``soft_moe_combine`` runs K2
with K1's saved combine stats, or K3 (online softmax) without them. The
JAX package wraps these in ``custom_vjp``s whose backward runs the
flash-style kernels K4/K5; their ``torch.autograd.Function``s come with
the training slice, and until then the CUDA wrappers refuse inputs that
need a gradient.

Per-sequence invariant: the batch axis is a pure grid axis. Every softmax
stat reduces within one row, so row i of a batched call equals a batch-1
call of that row, bitwise (``kernels/ref.py`` is the single-sequence
oracle).
"""
from __future__ import annotations

from typing import Optional

from . import ref
from .soft_moe_kernels import combine_apply, combine_online, routing_fwd
from .tuning import KernelConfig


def soft_moe_routing(x, phi_n, config: Optional[KernelConfig] = None, *,
                     with_d_stats: bool = False):
    """x: (b, m, d); phi_n: (d, S) pre-normalized.

    Returns ``(slots, (c_mx, c_den))``: the dispatched slots (b, S, d) and
    the combine-direction softmax stats (each (b, m)) from the same logits
    pass; hand the stats to :func:`soft_moe_combine` to skip its online
    rescan, and derive the ``max_combine`` metric as ``1 / c_den``.
    ``with_d_stats=True`` also returns the per-slot dispatch stats:
    ``(slots, (d_mx, d_den), (c_mx, c_den))``. ``config`` None means the
    default tile policy (``tuning.default_config``)."""
    slots, d_stats, c_stats = routing_fwd(x, phi_n, config)
    if with_d_stats:
        return slots, d_stats, c_stats
    return slots, c_stats


def soft_moe_dispatch(x, phi_n, config: Optional[KernelConfig] = None):
    """x: (b, m, d); phi_n: (d, S) pre-normalized -> slots (b, S, d)."""
    return soft_moe_routing(x, phi_n, config)[0]


def soft_moe_combine(x, phi_n, ys, c_stats=None,
                     config: Optional[KernelConfig] = None):
    """x: (b, m, d); phi_n: (d, S); ys: (b, S, d) -> y (b, m, d).

    ``c_stats``: the per-token (max, denom) from :func:`soft_moe_routing`
    (K2, no online rescan). Without it the kernel derives its own (K3)."""
    if c_stats is None:
        return combine_online(x, phi_n, ys, config)[0]
    return combine_apply(x, phi_n, ys, c_stats, config)


def normalized_phi(phi, scale):
    """phi: (d, n, p) -> (d, n*p) pre-normalized (O(d S), done outside the
    kernels; X is normalized inside them)."""
    return ref.normalized_phi(phi.reshape(phi.shape[0], -1), scale)
