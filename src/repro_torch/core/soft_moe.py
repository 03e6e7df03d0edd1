"""Soft MoE, the paper's layer (Puigcerver et al., ICLR 2024, section 2),
counterpart of ``repro/core/soft_moe.py``:

    logits = l2norm(X) @ (scale * l2norm(Phi))        # (m, n p)
    D = softmax over tokens  (per slot)               # dispatch
    C = softmax over slots   (per token)              # combine
    X~ = D^T X ; Y~_i = f_{i // p}(X~_i) ; Y = C Y~

``use_kernel=False`` is the einsum path, which materializes the (m x S)
weights; ``use_kernel=True`` routes dispatch and combine through the CUDA
kernels K1 and K2 (``kernels/ops.py``; their plain versions on CPU
tensors), which never write them to device memory, and whose autograd
Functions run the backward kernels K4 and K5; with ``telemetry=True``
the kernel path also runs K6 (routing health). Both softmaxes normalize
within one sequence, so a row's output does not depend on how it is
batched.
"""
from __future__ import annotations

import torch

from ..layers.common import l2_normalize, lecun_init
from ..layers.mlp import expert_init, experts_apply


def soft_moe_init(gen: torch.Generator, d_model: int, moe_cfg,
                  style: str = "gated"):
    n, p = moe_cfg.num_experts, moe_cfg.slots_per_expert
    d_ff = moe_cfg.expert_d_ff
    params = {
        "phi": lecun_init(gen, (d_model, n, p), fan_in=d_model),
        "scale": torch.ones((), device=gen.device),
        "experts": expert_init(gen, n, d_model, d_ff, style),
    }
    if moe_cfg.num_shared_experts:
        params["shared"] = expert_init(gen, moe_cfg.num_shared_experts,
                                       d_model, d_ff, style)
    return params


def soft_moe_weights(x, phi, scale, normalize: bool = True):
    """Dispatch/combine weights. x: (b, m, d); phi: (d, n, p). Returns
    (d_weights, c_weights), both (b, m, n, p) f32: D normalized over m, C
    over (n, p)."""
    if normalize:
        x = l2_normalize(x, axis=-1)
        phi = scale * l2_normalize(phi, axis=0)
    logits = torch.einsum("bmd,dnp->bmnp", x.float(), phi.float())
    d_weights = torch.softmax(logits, dim=1)  # over tokens (per slot)
    b, m, n, p = logits.shape
    c_weights = torch.softmax(logits.reshape(b, m, n * p), dim=-1).reshape(
        b, m, n, p)  # over all slots (per token)
    return d_weights, c_weights


def soft_moe_apply(params, moe_cfg, x, act: str = "silu",
                   use_kernel: bool = False, telemetry: bool = False):
    """x: (b, m, d) -> (b, m, d). Returns (y, metrics) with
    ``moe_aux_loss`` (0: balanced by construction) and ``max_combine``
    (the largest combine weight; on the kernel path 1 / c_den).

    ``telemetry=True`` adds ``metrics["telemetry"]``, the Fig. 9
    routing-health set as detached f32 scalars plus per-row (b,) ``rows``
    (see the JAX function). It never changes ``y``: the kernel path reads
    the routing pass's saved softmax stats through K6
    (``kernels/ops.py::routing_health``); the einsum path reduces the
    weights it already holds (``_dense_routing_health``)."""
    b, m, d = x.shape
    n, p = moe_cfg.num_experts, moe_cfg.slots_per_expert
    phi = params["phi"]
    c_weights = c_stats = d_w = d_stats = None
    if use_kernel:
        from ..kernels import ops as kops
        from ..kernels.tuning import config_from_moe

        kcfg = config_from_moe(moe_cfg, m=m, d=d)
        # normalized in phi's dtype, as the reference does; the kernels
        # take it in f32 (the reference's kernels widen it inside), so a
        # bf16 phi (a ZeRO-1 state's compute params) is widened here
        phi_n = kops.normalized_phi(phi, params["scale"]).float()
        # one logits pass: dispatched slots + the combine softmax stats
        if telemetry:
            slots, d_stats, c_stats = kops.soft_moe_routing(
                x, phi_n, config=kcfg, with_d_stats=True)
        else:
            slots, c_stats = kops.soft_moe_routing(x, phi_n, config=kcfg)
        slots = slots.reshape(b, n, p, d)
    else:
        d_w, c_weights = soft_moe_weights(x, phi, params["scale"])
        slots = torch.einsum("bmd,bmnp->bnpd", x.float(), d_w)
    slots = slots.to(x.dtype)

    # expert compute: (b, n, p, d) -> (n, b p, d), expert axis leading
    ys = slots.permute(1, 0, 2, 3).reshape(n, b * p, d)
    ys = experts_apply(params["experts"], ys, act)
    ys = ys.reshape(n, b, p, d).permute(1, 0, 2, 3)  # (b, n, p, d)

    if use_kernel:
        # the kernels take contiguous rows: with one slot per expert the
        # reshape below is a strided view, not a copy
        y = kops.soft_moe_combine(x, phi_n,
                                  ys.reshape(b, n * p, d).contiguous(),
                                  c_stats=c_stats, config=kcfg)
    else:
        y = torch.einsum("bnpd,bmnp->bmd", ys.float(), c_weights)
    y = y.to(x.dtype)

    if moe_cfg.num_shared_experts:
        # one leading-1 expert axis, broadcast by experts_apply
        sh = experts_apply(params["shared"], x.reshape(1, b * m, d), act)
        # the shared experts' sum accumulates in f32, as jnp.sum does
        y = y + sh.sum(0, dtype=torch.float32).to(sh.dtype).reshape(b, m, d)

    metrics = {"moe_aux_loss": torch.zeros((), device=x.device)}
    # max combine weight: values near 1 signal the softmax collapse the L2
    # norm prevents. On the kernel path token i's largest weight is
    # exp(mx_i - mx_i) / den_i = 1 / den_i.
    if c_weights is not None:
        metrics["max_combine"] = c_weights.max().detach()
    else:
        metrics["max_combine"] = (1.0 / c_stats[1]).max().detach()
    if telemetry:
        if use_kernel:
            dent, imp, cent, contrib = kops.routing_health(
                x, phi_n, d_stats, c_stats, config=kcfg)
            max_dispatch = (1.0 / d_stats[1]).max()
        else:
            dent, imp, cent, contrib = _dense_routing_health(
                d_w.detach(), c_weights.detach())
            max_dispatch = d_w.detach().max()
        imp_e = imp.reshape(b, n, p).sum(dim=(0, 2))  # per-expert mass
        metrics["telemetry"] = {
            "max_combine": metrics["max_combine"],
            "max_dispatch": max_dispatch.float(),
            "dispatch_entropy": dent.mean().float(),
            "combine_entropy": cent.mean().float(),
            "expert_importance_spread": (
                imp_e.max() / torch.clamp(imp_e.min(), min=1e-9)).float(),
            "token_contribution_min": contrib.min().float(),
            "token_contribution_max": contrib.max().float(),
            # per-sequence rows (b,): Soft MoE's softmaxes are per row, so
            # these do not move with the batch's composition
            "rows": {
                "dispatch_entropy": dent.mean(dim=1).float(),
                "combine_entropy": cent.mean(dim=1).float(),
                "token_contribution_min": contrib.amin(dim=1).float(),
            },
        }
    return y, metrics


def _dense_routing_health(d_w, c_weights):
    """Dense oracle of K6's reductions. d_w, c_weights: (b, m, n, p)
    softmax weights. Returns ``(disp_entropy (b, S), importance (b, S),
    comb_entropy (b, m), token_contrib (b, m))`` as
    ``kernels.ops.routing_health``."""
    b, m, n, p = d_w.shape
    d_flat = d_w.reshape(b, m, n * p)
    c_flat = c_weights.reshape(b, m, n * p)

    def ent(w, dim):
        return -torch.where(w > 0, w * torch.log(torch.clamp(w, min=1e-30)),
                            0.0).sum(dim)

    return (ent(d_flat, 1), c_flat.sum(1), ent(c_flat, 2), d_flat.sum(2))
