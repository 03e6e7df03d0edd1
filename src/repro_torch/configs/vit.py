"""The paper's own model family: ViT backbones and their Soft-MoE variants.

A copy of the JAX package's ``configs/vit.py``.

Paper (§3): ViT S/16, B/16, L/16, H/14 with the second half of MLP blocks
replaced by Soft MoE layers (128 or 256 experts, one slot per expert).
These are encoders (non-causal), the paper's native domain.
"""
from __future__ import annotations

import dataclasses

from .base import AttentionConfig, FrontendConfig, ModelConfig, MoEConfig

_VIT_DIMS = {
    # name: (layers, d_model, heads, d_ff)
    "s": (12, 384, 6, 1536),
    "b": (12, 768, 12, 3072),
    "l": (24, 1024, 16, 4096),
    "h": (32, 1280, 16, 5120),
}


def vit(size: str, patch: int, image_size: int = 224) -> ModelConfig:
    layers, d, heads, d_ff = _VIT_DIMS[size]
    tokens = (image_size // patch) ** 2
    return ModelConfig(
        name=f"vit-{size}/{patch}",
        family="vit",
        num_layers=layers,
        d_model=d,
        d_ff=d_ff,
        vocab_size=0,  # classifier head attached by the model, not vocab
        max_seq_len=tokens,
        attention=AttentionConfig(
            kind="gqa", num_heads=heads, num_kv_heads=heads,
            head_dim=d // heads,
        ),
        frontend=FrontendConfig(kind="vision", embed_dim=patch * patch * 3,
                                num_embeds=tokens),
        causal=False,
        norm="layernorm",
        act="gelu",
        mlp_style="classic",  # paper ViT/expert MLPs: fc1-gelu-fc2
    )


def soft_moe_vit(size: str, patch: int, num_experts: int,
                 slots_per_expert: int = 1, variant: str = "soft",
                 image_size: int = 224) -> ModelConfig:
    """Paper default: MoE in the second half of blocks, 1 slot/expert."""
    base = vit(size, patch, image_size)
    return dataclasses.replace(
        base,
        name=f"{variant}-moe-{size}/{patch}-{num_experts}e",
        moe=MoEConfig(variant=variant, num_experts=num_experts,
                      slots_per_expert=slots_per_expert),
        moe_layers="second_half",
    )


# The long-run configs from Table 1/2.
SOFT_MOE_S16_128E = soft_moe_vit("s", 16, 128)
SOFT_MOE_S14_256E = soft_moe_vit("s", 14, 256)
SOFT_MOE_B16_128E = soft_moe_vit("b", 16, 128)
SOFT_MOE_L16_128E = soft_moe_vit("l", 16, 128)
SOFT_MOE_H14_128E = soft_moe_vit("h", 14, 128)
SOFT_MOE_H14_256E = soft_moe_vit("h", 14, 256)
VIT_S16 = vit("s", 16)
VIT_B16 = vit("b", 16)
VIT_L16 = vit("l", 16)
VIT_H14 = vit("h", 14)

PAPER_MODELS = (
    VIT_S16, VIT_B16, VIT_L16, VIT_H14,
    SOFT_MOE_S16_128E, SOFT_MOE_S14_256E, SOFT_MOE_B16_128E,
    SOFT_MOE_L16_128E, SOFT_MOE_H14_128E, SOFT_MOE_H14_256E,
)
