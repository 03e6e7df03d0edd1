"""MoE core, counterpart of ``repro/core``: Soft MoE (the paper's
technique), the sparse baselines (Tokens Choice, Experts Choice) and the
fixed-routing ablations. ``moe_init`` / ``moe_apply`` dispatch on
``MoEConfig.variant`` so models treat every router alike."""
from __future__ import annotations

import dataclasses

from .ablations import ablation_apply, ablation_init  # noqa: F401
from .soft_moe import soft_moe_apply, soft_moe_init, soft_moe_weights  # noqa: F401
from .sparse_moe import (  # noqa: F401
    experts_choice_apply,
    sparse_moe_init,
    tokens_choice_apply,
)

_ABLATIONS = ("identity", "uniform", "soft_uniform", "uniform_soft")
_SPARSE = ("tokens_choice", "experts_choice")


def resolve_moe_cfg(moe_cfg, d_ff_default: int):
    """expert_d_ff == 0 means 'inherit the model d_ff'."""
    if moe_cfg.expert_d_ff == 0:
        if d_ff_default <= 0:
            raise ValueError(
                "MoE layer with expert_d_ff=0 needs a model d_ff to inherit")
        return dataclasses.replace(moe_cfg, expert_d_ff=d_ff_default)
    return moe_cfg


def moe_init(gen, d_model: int, moe_cfg, style: str = "gated"):
    if moe_cfg.expert_d_ff <= 0:
        raise ValueError("resolve expert_d_ff first (block_init does)")
    if moe_cfg.variant == "soft" or moe_cfg.variant in _ABLATIONS:
        return soft_moe_init(gen, d_model, moe_cfg, style)
    if moe_cfg.variant in _SPARSE:
        return sparse_moe_init(gen, d_model, moe_cfg, style)
    raise ValueError(f"unknown MoE variant {moe_cfg.variant!r}")


def moe_apply(params, moe_cfg, x, act: str = "silu",
              use_kernel: bool = False, telemetry: bool = False,
              mode: str = "train"):
    """``telemetry`` adds ``metrics["telemetry"]`` (detached routing
    health) on the soft and sparse variants, ``y`` unchanged; the
    ablations have no router to probe and ignore it. ``mode`` sets the
    sparse variants' routing scope: ``"train"`` keeps the paper's
    batch-coupled group routing, the serving modes (``"prefill"``,
    ``"decode"``) route each row alone and droplessly. Soft MoE and the
    ablations normalize within each sequence in every mode and ignore
    it; only Soft MoE has a kernel route (``use_kernel``)."""
    if moe_cfg.variant == "soft":
        return soft_moe_apply(params, moe_cfg, x, act, use_kernel=use_kernel,
                              telemetry=telemetry)
    if moe_cfg.variant in _ABLATIONS:
        return ablation_apply(params, moe_cfg, x, act)
    if moe_cfg.variant == "tokens_choice":
        return tokens_choice_apply(params, moe_cfg, x, act,
                                   telemetry=telemetry, mode=mode)
    if moe_cfg.variant == "experts_choice":
        return experts_choice_apply(params, moe_cfg, x, act,
                                    telemetry=telemetry, mode=mode)
    raise ValueError(f"unknown MoE variant {moe_cfg.variant!r}")
