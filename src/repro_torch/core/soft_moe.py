"""Soft MoE, the paper's layer (Puigcerver et al., ICLR 2024, section 2),
counterpart of ``repro/core/soft_moe.py``:

    logits = l2norm(X) @ (scale * l2norm(Phi))        # (m, n p)
    D = softmax over tokens  (per slot)               # dispatch
    C = softmax over slots   (per token)              # combine
    X~ = D^T X ; Y~_i = f_{i // p}(X~_i) ; Y = C Y~

``use_kernel=False`` is the einsum path, which materializes the (m x S)
weights; ``use_kernel=True`` routes dispatch and combine through the CUDA
kernels K1 and K2 (``kernels/ops.py``; their plain versions on CPU
tensors), which never write them to device memory. Both softmaxes
normalize within one sequence, so a row's output does not depend on how
it is batched.
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
    (the largest combine weight; on the kernel path 1 / c_den)."""
    if telemetry:
        raise NotImplementedError(
            "Soft-MoE telemetry (the routing-health kernel K6) is not "
            "ported yet")
    b, m, d = x.shape
    n, p = moe_cfg.num_experts, moe_cfg.slots_per_expert
    phi = params["phi"]
    c_weights = c_stats = None
    if use_kernel:
        from ..kernels import ops as kops
        from ..kernels.tuning import config_from_moe

        kcfg = config_from_moe(moe_cfg, m=m, d=d)
        phi_n = kops.normalized_phi(phi, params["scale"])
        # one logits pass: dispatched slots + the combine softmax stats
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
        y = y + sh.sum(0).reshape(b, m, d)

    metrics = {"moe_aux_loss": torch.zeros((), device=x.device)}
    # max combine weight: values near 1 signal the softmax collapse the L2
    # norm prevents. On the kernel path token i's largest weight is
    # exp(mx_i - mx_i) / den_i = 1 / den_i.
    if c_weights is not None:
        metrics["max_combine"] = c_weights.max().detach()
    else:
        metrics["max_combine"] = (1.0 / c_stats[1]).max().detach()
    return y, metrics
