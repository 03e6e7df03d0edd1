"""Vision Transformer, the paper's own backbone family (section 3),
counterpart of ``repro/models/vit.py``: flattened patches projected
linearly plus a learned position embedding, non-causal encoder blocks
(Soft-MoE layers in the second half, per the config), then mean-pool and
a linear head.

Params hold one dict per layer under ``"layers"`` and the port runs them
in a Python loop (the JAX package scans each segment of stacked layers;
``convert.params_from_jax`` splits them). With ``cfg.remat`` (the config
default) ``vit_apply`` runs each block under activation checkpointing
when a gradient is being recorded, as the JAX ``vit_apply`` wraps its scan
body in ``jax.checkpoint``: the backward keeps only the blocks' inputs
and recomputes each block's forward, Soft-MoE kernels included.
``vit_features`` does not remat, as in JAX. Two traits of the reference
are kept, because the port is held to it: attention applies RoPE to q/k
on top of the learned ``pos_emb`` (``layers/attention.py::gqa_apply``),
and the head starts at zero.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..layers.common import (
    dtype_of,
    lecun_init,
    norm_apply,
    norm_init,
    truncated_normal,
)
from ..tracing import span
from .lm import block_apply, block_init


def vit_init(gen: torch.Generator, cfg, num_classes: int = 1000):
    """Random parameters drawn from ``gen`` on its device, in f32."""
    d = cfg.d_model
    dev = gen.device
    moe_idx = set(cfg.moe_layer_indices())
    return {
        "patch_proj": {
            "w": lecun_init(gen, (cfg.frontend.embed_dim, d),
                            fan_in=cfg.frontend.embed_dim),
            "b": torch.zeros(d, device=dev),
        },
        "pos_emb": truncated_normal(gen, (cfg.frontend.num_embeds, d), 0.02),
        "layers": [block_init(gen, cfg, i in moe_idx)
                   for i in range(cfg.num_layers)],
        "final_norm": norm_init(cfg, d, dev),
        "head": {
            "w": torch.zeros(d, num_classes, device=dev),
            "b": torch.zeros(num_classes, device=dev),
        },
    }


def _encode(params, cfg, patches, use_kernel: bool, remat: bool):
    """patches -> (final-normed tokens (B, m, d), summed aux loss)."""
    dt = dtype_of(cfg.dtype)
    x = patches.to(dt) @ params["patch_proj"]["w"].to(dt)
    x = x + params["patch_proj"]["b"].to(dt)
    x = x + params["pos_emb"].to(dt)
    moe_idx = set(cfg.moe_layer_indices())
    aux = torch.zeros((), device=x.device)
    remat = remat and torch.is_grad_enabled()
    for i, p in enumerate(params["layers"]):
        def body(h, p=p, is_moe=i in moe_idx):
            y, _, a = block_apply(p, cfg, h, is_moe=is_moe, mode="train",
                                  use_kernel=use_kernel)
            return y, a

        x, a = (checkpoint(body, x, use_reentrant=False) if remat
                else body(x))
        aux = aux + a
    return norm_apply(params["final_norm"], cfg, x), aux


@span("vit/apply", root=True)
def vit_apply(params, cfg, patches, use_kernel: bool = False):
    """patches: (B, num_patches, patch_dim) -> ((B, num_classes) f32
    logits, aux loss). A root span, ``vit/apply``: a call outside a
    train step leaves a step record of its own (``repro_torch.tracing``).
    """
    x, aux = _encode(params, cfg, patches, use_kernel, cfg.remat)
    pooled = x.mean(dim=1).float()
    logits = pooled @ params["head"]["w"].float() + params["head"]["b"]
    return logits, aux


def vit_loss(params, cfg, batch, use_kernel: bool = False):
    """batch: {"patches", "labels"} -> (nll + aux, {"loss", "aux_loss",
    "accuracy"})."""
    logits, aux = vit_apply(params, cfg, batch["patches"],
                            use_kernel=use_kernel)
    labels = batch["labels"].long()
    lp = torch.log_softmax(logits, dim=-1)
    nll = -lp.gather(-1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll + aux, {"loss": nll, "aux_loss": aux, "accuracy": acc}


def vit_features(params, cfg, patches, use_kernel: bool = False):
    """Mean-pooled pre-head features (B, d) in the compute dtype."""
    return _encode(params, cfg, patches, use_kernel, False)[0].mean(dim=1)
