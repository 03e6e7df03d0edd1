"""Gated MLP (SwiGLU/GeGLU) and the classic fc1-act-fc2 MLP, counterpart
of ``repro/layers/mlp.py``. The expert stack waits for the Soft-MoE
slice."""
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
