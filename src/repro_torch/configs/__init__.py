"""Config registry: ``get_config(name)`` / ``list_configs()``.

The port's own copy of the JAX package's config registry (plain
dataclasses, no framework). Names accept an optional ``+soft`` suffix
which switches the MoE variant of an assigned arch to Soft MoE (or adds
Soft-MoE layers to a dense arch, paper placement: second half of blocks).
The paper's ViT table (``configs/vit.py``) is registered beside the
assigned archs.
"""
from __future__ import annotations

import dataclasses

from .archs import ASSIGNED
from .base import (  # noqa: F401
    AttentionConfig,
    FrontendConfig,
    ModelConfig,
    MoEConfig,
    SHAPES,
    ShapeConfig,
    SSMConfig,
    reduced,
    shape_supported,
)
from .vit import PAPER_MODELS, soft_moe_vit, vit  # noqa: F401

_REGISTRY = {m.name: m for m in ASSIGNED}
_REGISTRY.update({m.name: m for m in PAPER_MODELS})

ASSIGNED_NAMES = tuple(m.name for m in ASSIGNED)


def softify(cfg: ModelConfig, num_experts: int | None = None) -> ModelConfig:
    """Return the Soft-MoE variant of an arch (paper technique applied)."""
    if cfg.ssm is not None and cfg.attention is None and cfg.d_ff == 0:
        raise ValueError(
            f"{cfg.name}: Soft MoE replaces MLP blocks and this arch has "
            "none (inapplicable)."
        )
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, variant="soft",
            num_experts=num_experts or cfg.moe.num_experts,
        )
        layers = cfg.moe_layers
    else:
        moe = MoEConfig(variant="soft", num_experts=num_experts or 128,
                        expert_d_ff=cfg.d_ff)
        layers = "second_half"
    return dataclasses.replace(
        cfg, name=cfg.name + "+soft", moe=moe, moe_layers=layers
    )


def get_config(name: str) -> ModelConfig:
    base, plus, suffix = name.partition("+")
    if base not in _REGISTRY:
        raise KeyError(
            f"unknown arch {base!r}; available: {sorted(_REGISTRY)}"
        )
    cfg = _REGISTRY[base]
    if plus:
        if suffix != "soft":
            raise KeyError(f"unknown variant suffix {suffix!r}")
        cfg = softify(cfg)
    return cfg


def list_configs() -> list[str]:
    return sorted(_REGISTRY)
