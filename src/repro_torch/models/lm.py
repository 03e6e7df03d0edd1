"""Decoder-only LM, dense GQA family, counterpart of ``repro/models/lm.py``;
its transformer block also carries the Soft-MoE layers of the ViT
(``models/vit.py``).

The port runs every layer in a Python loop (the JAX package's unrolled
serving path). Params hold one dict per layer under ``"layers"``; the
JAX package stacks the layers of each homogeneous segment on a leading
axis instead (``convert.params_from_jax`` splits them). LMs with MoE,
SSM or frontend blocks, and the scan/remat training path, wait for later
slices (``check_supported``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..core import moe_apply, moe_init, resolve_moe_cfg
from ..layers.attention import attention_apply, attention_init
from ..layers.common import dtype_of, norm_apply, norm_init
from ..layers.embedding import embed, embedding_init, unembed
from ..layers.mlp import mlp_apply, mlp_init


def segment_plan(cfg, n_layers: Optional[int] = None
                 ) -> List[Tuple[int, int, bool]]:
    """Contiguous runs of (start, count, is_moe) with identical structure."""
    n = n_layers if n_layers is not None else cfg.num_layers
    moe_idx = set(cfg.moe_layer_indices())
    segs: List[Tuple[int, int, bool]] = []
    for i in range(n):
        is_moe = i in moe_idx
        if segs and segs[-1][2] == is_moe:
            start, count, _ = segs[-1]
            segs[-1] = (start, count + 1, is_moe)
        else:
            segs.append((i, 1, is_moe))
    return segs


def check_supported(cfg):
    """Raise for the parts of the config family the port lacks so far."""
    missing = []
    if cfg.moe_layer_indices():
        missing.append("MoE layers")
    if cfg.has_ssm():
        missing.append("SSM blocks")
    if not cfg.has_attention() or cfg.attention.kind != "gqa":
        missing.append("non-GQA attention")
    if cfg.frontend.kind != "none" or cfg.encoder_layers:
        missing.append("frontends / encoder-decoder")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(missing)}")


def block_init(gen: torch.Generator, cfg, is_moe: bool = False):
    d = cfg.d_model
    dev = gen.device
    p = {"norm1": norm_init(cfg, d, dev), "attn": attention_init(gen, cfg)}
    if is_moe:
        p["norm2"] = norm_init(cfg, d, dev)
        p["moe"] = moe_init(gen, d, resolve_moe_cfg(cfg.moe, cfg.d_ff),
                            cfg.mlp_style)
    elif cfg.d_ff > 0:
        p["norm2"] = norm_init(cfg, d, dev)
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp_style)
    return p


def block_apply(params, cfg, x, *, is_moe: bool = False,
                is_global: bool = True, positions=None, cache=None,
                mode: str = "train", use_kernel: bool = False,
                block_tables=None, paged_kernel: bool = False):
    """Returns (y, cache, aux). ``is_moe`` runs the block's MLP as a Soft-MoE
    layer (``use_kernel`` routes it through the routing and combine
    kernels); aux is its auxiliary loss (the float 0.0 otherwise, so a
    dense block launches nothing for it). ``block_tables``
    (B, blocks_per_row) switches the attention cache to the paged
    block-pool layout; ``paged_kernel`` routes paged single-token decode
    through the paged decode-attention kernel."""
    aux = 0.0
    xn = norm_apply(params["norm1"], cfg, x)
    a_out, a_cache = attention_apply(
        params["attn"], cfg, xn, layer_is_global=is_global,
        positions=positions,
        cache=None if cache is None else cache.get("attn"),
        mode=mode, block_tables=block_tables, paged_kernel=paged_kernel,
    )
    x = x + a_out
    if "norm2" in params:
        xn = norm_apply(params["norm2"], cfg, x)
        if is_moe:
            m_out, metrics = moe_apply(
                params["moe"], resolve_moe_cfg(cfg.moe, cfg.d_ff), xn,
                cfg.act, use_kernel=use_kernel, mode=mode)
            aux = aux + metrics["moe_aux_loss"]
        else:
            m_out = mlp_apply(params["mlp"], xn, cfg.act)
        x = x + m_out
    return x, None if cache is None else {"attn": a_cache}, aux


def lm_init(gen: torch.Generator, cfg):
    """Random parameters drawn from ``gen`` on its device, in f32 (the
    configs' ``param_dtype``)."""
    check_supported(cfg)
    params = {"embed": embedding_init(gen, cfg.vocab_size, cfg.d_model)}
    params["layers"] = [block_init(gen, cfg) for _ in range(cfg.num_layers)]
    params["final_norm"] = norm_init(cfg, cfg.d_model, gen.device)
    if not cfg.tie_embeddings and cfg.vocab_size:
        params["unembed"] = embedding_init(gen, cfg.vocab_size, cfg.d_model)
    return params


def lm_apply(params, cfg, tokens, *, positions=None, cache=None,
             mode: str = "train", last_only: bool = False,
             block_tables=None, paged_kernel: bool = False):
    """tokens: (B, S) int; positions: (S,) shared or (B, S) per-row
    (entries < 0 mark pad/inactive tokens that neither write nor read any
    cache). ``cache`` is the per-layer list of paged pools (updated in
    place) addressed through ``block_tables`` (B, blocks_per_row);
    ``paged_kernel`` streams paged single-token decode through the kernel.
    ``last_only`` unembeds only the final position. Returns (logits (B,
    S|1, V) f32, cache, aux) like the JAX function; aux is 0 (no MoE)."""
    check_supported(cfg)
    x = embed(params["embed"], tokens, dtype_of(cfg.dtype))
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    for i, p in enumerate(params["layers"]):
        x, _, _ = block_apply(
            p, cfg, x, is_global=cfg.attention.is_global_layer(i),
            positions=positions,
            cache=None if cache is None else cache[i], mode=mode,
            block_tables=block_tables, paged_kernel=paged_kernel,
        )
    if last_only:
        x = x[:, -1:]
    x = norm_apply(params["final_norm"], cfg, x)
    table = params["unembed"] if "unembed" in params else params["embed"]
    logits = unembed(table, x, cfg.logits_softcap)
    return logits, cache, torch.zeros((), device=logits.device)
