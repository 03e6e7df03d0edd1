"""MoE core, counterpart of ``repro/core``: Soft MoE (the paper's
technique). ``moe_init`` / ``moe_apply`` dispatch on
``MoEConfig.variant``; the sparse baselines and the ablations are not
ported yet and raise."""
from __future__ import annotations

import dataclasses

from .soft_moe import soft_moe_apply, soft_moe_init, soft_moe_weights  # noqa: F401

_ABLATIONS = ("identity", "uniform", "soft_uniform", "uniform_soft")
_UNPORTED = ("tokens_choice", "experts_choice") + _ABLATIONS


def resolve_moe_cfg(moe_cfg, d_ff_default: int):
    """expert_d_ff == 0 means 'inherit the model d_ff'."""
    if moe_cfg.expert_d_ff == 0:
        if d_ff_default <= 0:
            raise ValueError(
                "MoE layer with expert_d_ff=0 needs a model d_ff to inherit")
        return dataclasses.replace(moe_cfg, expert_d_ff=d_ff_default)
    return moe_cfg


def _check_variant(variant: str):
    if variant in _UNPORTED:
        raise NotImplementedError(
            f"MoE variant {variant!r} is not ported yet (only 'soft')")
    if variant != "soft":
        raise ValueError(f"unknown MoE variant {variant!r}")


def moe_init(gen, d_model: int, moe_cfg, style: str = "gated"):
    if moe_cfg.expert_d_ff <= 0:
        raise ValueError("resolve expert_d_ff first (block_init does)")
    _check_variant(moe_cfg.variant)
    return soft_moe_init(gen, d_model, moe_cfg, style)


def moe_apply(params, moe_cfg, x, act: str = "silu",
              use_kernel: bool = False, telemetry: bool = False,
              mode: str = "train"):
    """Soft MoE normalizes within each sequence in every mode, so ``mode``
    (the sparse variants' routing scope) changes nothing here."""
    _check_variant(moe_cfg.variant)
    return soft_moe_apply(params, moe_cfg, x, act, use_kernel=use_kernel,
                          telemetry=telemetry)
