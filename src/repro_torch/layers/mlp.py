"""Gated MLP (SwiGLU/GeGLU) and the classic fc1-act-fc2 MLP, also the
expert function of every MoE variant (stacked on a leading expert axis);
counterpart of ``repro/layers/mlp.py``."""
from __future__ import annotations

import torch

from .common import activation, lecun_init


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             style: str = "gated"):
    p = {
        "w_up": lecun_init(gen, (d_model, d_ff), fan_in=d_model),
        "w_down": lecun_init(gen, (d_ff, d_model), fan_in=d_ff),
    }
    if style == "gated":
        p["w_gate"] = lecun_init(gen, (d_model, d_ff), fan_in=d_model)
    return p


def mlp_apply(params, x: torch.Tensor, act: str = "silu"):
    dt = x.dtype
    f = activation(act)
    up = x @ params["w_up"].to(dt)
    if "w_gate" in params:  # SwiGLU
        h = f(x @ params["w_gate"].to(dt)) * up
    else:  # classic fc1-act-fc2 (the paper's ViT MLP)
        h = f(up)
    return h @ params["w_down"].to(dt)


def expert_init(gen: torch.Generator, num_experts: int, d_model: int,
                d_ff: int, style: str = "gated"):
    """Stacked expert params: leading axis = expert."""
    if d_ff <= 0:
        raise ValueError("expert_d_ff resolved to 0: zero-width experts "
                         "(MoEConfig uses 0 as 'inherit model d_ff'; "
                         "resolve it before init, as moe_init does)")
    p = {
        "w_up": lecun_init(gen, (num_experts, d_model, d_ff), fan_in=d_model),
        "w_down": lecun_init(gen, (num_experts, d_ff, d_model), fan_in=d_ff),
    }
    if style == "gated":
        p["w_gate"] = lecun_init(gen, (num_experts, d_model, d_ff),
                                 fan_in=d_model)
    return p


def experts_apply(params, xs: torch.Tensor, act: str = "silu"):
    """xs: (num_experts | 1, slots, d) -> (num_experts, slots, d). Batched
    matmuls, so a leading 1 broadcasts against the expert axis (shared
    experts see every token without a broadcast copy)."""
    dt = xs.dtype
    f = activation(act)
    up = torch.matmul(xs, params["w_up"].to(dt))
    if "w_gate" in params:
        h = f(torch.matmul(xs, params["w_gate"].to(dt))) * up
    else:
        h = f(up)
    return torch.matmul(h, params["w_down"].to(dt))
