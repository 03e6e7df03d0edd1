"""Fixed-routing ablations (paper Table 3 / Appendix A), counterpart of
``repro/core/ablations.py``:

  * identity      token i -> slot i mod (n p) (round robin); D and C are
                  the (per-slot normalized) one-hots, the identity when
                  m == n p;
  * uniform       D = 1/m everywhere, C = 1/(n p) everywhere;
  * soft_uniform  learned dispatch D, uniform combine C;
  * uniform_soft  uniform dispatch D, learned combine C.

The learned sides are Soft MoE's (``soft_moe_weights``). The ablations
have no router to probe, so they take no telemetry, and they route
within one sequence in every mode.
"""
from __future__ import annotations

import torch

from ..layers.mlp import experts_apply
from .soft_moe import soft_moe_init, soft_moe_weights


def ablation_init(gen: torch.Generator, d_model: int, moe_cfg,
                  style: str = "gated"):
    """Soft MoE's params (Phi is unused by the fixed sides, but kept so
    checkpoints and configs stay interchangeable)."""
    return soft_moe_init(gen, d_model, moe_cfg, style)


def _round_robin(m: int, n: int, p: int, device):
    """(m, n, p) one-hot of slot t mod (n p) for each token t."""
    assign = torch.arange(m, device=device) % (n * p)
    return torch.nn.functional.one_hot(assign, n * p).float().reshape(m, n, p)


def _round_robin_dispatch(m: int, n: int, p: int, device):
    """D[t, slot] one-hot on slot = t mod (n p), normalized per slot."""
    d = _round_robin(m, n, p, device)
    return d / torch.clamp(d.sum(0, keepdim=True), min=1.0)


def ablation_apply(params, moe_cfg, x, act: str = "silu"):
    b, m, d = x.shape
    n, p = moe_cfg.num_experts, moe_cfg.slots_per_expert
    variant = moe_cfg.variant
    shape = (b, m, n, p)

    if variant in ("soft_uniform", "uniform_soft"):
        learned_d, learned_c = soft_moe_weights(x, params["phi"],
                                                params["scale"])

    def full(v):
        return torch.full(shape, v, device=x.device)

    if variant == "identity":
        d_w = _round_robin_dispatch(m, n, p, x.device).expand(shape)
        c_w = _round_robin(m, n, p, x.device).expand(shape)
    elif variant == "uniform":
        d_w, c_w = full(1.0 / m), full(1.0 / (n * p))
    elif variant == "soft_uniform":  # learned dispatch / uniform combine
        d_w, c_w = learned_d, full(1.0 / (n * p))
    elif variant == "uniform_soft":  # uniform dispatch / learned combine
        d_w, c_w = full(1.0 / m), learned_c
    else:
        raise ValueError(f"unknown ablation variant {variant!r}")

    slots = torch.einsum("bmd,bmnp->bnpd", x.float(), d_w)
    ys = slots.to(x.dtype).permute(1, 0, 2, 3).reshape(n, b * p, d)
    ys = experts_apply(params["experts"], ys, act)
    ys = ys.reshape(n, b, p, d).permute(1, 0, 2, 3)
    y = torch.einsum("bnpd,bmnp->bmd", ys.float(), c_w)
    return y.to(x.dtype), {"moe_aux_loss": torch.zeros((), device=x.device)}
