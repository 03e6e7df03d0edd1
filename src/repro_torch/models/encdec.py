"""Encoder-decoder backbone (seamless-m4t), counterpart of
``repro/models/encdec.py``: the audio frontend stub projects precomputed
frame embeddings into the encoder; the decoder self-attends causally
and cross-attends to the encoder output.

The encoder is non-causal, so Soft MoE applies there as in the paper's
own setting. Params hold one dict a layer under ``"enc_layers"`` (the
JAX package stacks each homogeneous run under ``"enc_segments"``;
``convert.params_from_jax`` splits them) and a list ``"dec_blocks"`` of
``{"self", "cross_norm", "cross"}``, as in the reference. The reference
runs no kernel here: the blocks take the MoE einsum path and attention
gathers the ring, so neither ``use_kernel`` nor ``paged_kernel``
exists on this path.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..layers.attention import (
    _CHUNKED_THRESHOLD,
    _attend,
    _attend_chunked,
    gqa_init,
    init_kv_cache,
)
from ..layers.common import dtype_of, lecun_init, norm_apply, norm_init
from ..layers.embedding import embed, embedding_init, unembed
from .lm import block_apply, block_init, cross_entropy


# --- cross attention --------------------------------------------------------


def cross_attn_init(gen: torch.Generator, cfg):
    return gqa_init(gen, cfg)


def cross_attn_apply(params, cfg, x, enc_kv):
    """x: (B,S,d) decoder side; enc_kv: ``{"k", "v"}`` (B,T,G,hd) from
    ``cross_kv``. No RoPE on the cross query or keys, no mask: every
    frame is visible. Above ``_CHUNKED_THRESHOLD`` the chunked path runs
    with the reference's zero positions and no causal mask."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k, v = enc_kv["k"], enc_kv["v"]
    if k.shape[1] * x.shape[1] > _CHUNKED_THRESHOLD:
        zeros = torch.zeros(x.shape[1], dtype=torch.int32, device=x.device)
        kpos = torch.zeros(k.shape[1], dtype=torch.int32, device=x.device)
        out = _attend_chunked(q, k, v, zeros, kpos, False, None)
    else:
        out = _attend(q, k, v, None)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))


def cross_kv(params, cfg, enc_out):
    """The cross-attention keys and values of the encoder output."""
    dt = enc_out.dtype
    return {"k": torch.einsum("btd,dgk->btgk", enc_out, params["wk"].to(dt)),
            "v": torch.einsum("btd,dgk->btgk", enc_out, params["wv"].to(dt))}


# --- model ------------------------------------------------------------------


def _enc_cfg(cfg):
    return dataclasses.replace(cfg, causal=False,
                               num_layers=cfg.encoder_layers)


def encdec_init(gen: torch.Generator, cfg):
    """Random f32 parameters drawn from ``gen`` on its device: the
    embedding, the frontend projection, the encoder layers, the encoder
    norm, the decoder blocks, the final norm and (untied) the unembed."""
    dev = gen.device
    enc_cfg = _enc_cfg(cfg)
    enc_moe = set(enc_cfg.moe_layer_indices())
    dec_moe = set(cfg.moe_layer_indices())
    fe = cfg.frontend.embed_dim
    params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model),
        "frontend": {"w": lecun_init(gen, (fe, cfg.d_model), fan_in=fe)},
        "enc_layers": [block_init(gen, enc_cfg, i in enc_moe)
                       for i in range(enc_cfg.num_layers)],
        "enc_norm": norm_init(cfg, cfg.d_model, dev),
    }
    params["dec_blocks"] = [
        {"self": block_init(gen, cfg, i in dec_moe),
         "cross_norm": norm_init(cfg, cfg.d_model, dev),
         "cross": cross_attn_init(gen, cfg)}
        for i in range(cfg.num_layers)]
    params["final_norm"] = norm_init(cfg, cfg.d_model, dev)
    if not cfg.tie_embeddings:
        params["unembed"] = embedding_init(gen, cfg.vocab_size, cfg.d_model)
    return params


def encode(params, cfg, frames):
    """frames: (B, T, E) precomputed frontend embeddings (the stub).
    Returns (the normed encoder output (B, T, d), the blocks' summed
    auxiliary loss). The blocks are non-causal and run in train mode;
    with ``cfg.remat`` and grad on, each runs under activation
    checkpointing, as the reference's remat'd scan does. The reference's
    ``constrain`` is a sharding hint, a no-op on one device, and is left
    out."""
    enc_cfg = _enc_cfg(cfg)
    enc_moe = set(enc_cfg.moe_layer_indices())
    dt = dtype_of(cfg.dtype)
    x = frames.to(dt) @ params["frontend"]["w"].to(dt)
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, p in enumerate(params["enc_layers"]):
        def body(h, p=p, is_moe=i in enc_moe):
            y, _, a = block_apply(p, enc_cfg, h, is_moe=is_moe, mode="train")
            return y, a

        x, a = checkpoint(body, x, use_reentrant=False) if remat else body(x)
        aux = aux + a
    return norm_apply(params["enc_norm"], cfg, x), aux


def decode_step(params, cfg, tokens, enc_out, *, positions=None,
                cache=None, mode: str = "train", last_only: bool = False):
    """The decoder over ``tokens`` with cross-attention to ``enc_out``.
    ``cache`` (``init_encdec_cache``) is updated in place: each layer's
    ``"self"`` ring, and its ``"cross_kv"``, computed from ``enc_out`` at
    the first call and read back afterwards. Returns (logits, cache,
    aux)."""
    dt = dtype_of(cfg.dtype)
    x = embed(params["embed"], tokens, dt)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), device=x.device)
    moe_idx = set(cfg.moe_layer_indices())
    for i, blk in enumerate(params["dec_blocks"]):
        cache_i = None if cache is None else cache[i]
        x, c, a = block_apply(
            blk["self"], cfg, x, is_moe=i in moe_idx, positions=positions,
            cache=None if cache_i is None else cache_i.get("self"),
            mode=mode)
        aux = aux + a
        xn = norm_apply(blk["cross_norm"], cfg, x)
        if cache_i is not None and "cross_kv" in cache_i:
            kv = cache_i["cross_kv"]
        else:
            kv = cross_kv(blk["cross"], cfg, enc_out)
        x = x + cross_attn_apply(blk["cross"], cfg, xn, kv)
        if cache_i is not None:
            cache_i["self"], cache_i["cross_kv"] = c, kv
    if last_only:
        x = x[:, -1:]
    x = norm_apply(params["final_norm"], cfg, x)
    table = params["unembed"] if "unembed" in params else params["embed"]
    return unembed(table, x, cfg.logits_softcap), cache, aux


def encdec_apply(params, cfg, tokens, frames, *, positions=None, cache=None,
                 enc_out=None, mode: str = "train"):
    """The whole forward. To decode, pass ``enc_out`` (and the cache)
    from an earlier call instead of frames. Returns (logits, (enc_out,
    cache), aux)."""
    aux = torch.zeros((), device=tokens.device)
    if enc_out is None:
        enc_out, enc_aux = encode(params, cfg, frames)
        aux = aux + enc_aux
    logits, cache, dec_aux = decode_step(
        params, cfg, tokens, enc_out, positions=positions, cache=cache,
        mode=mode)
    return logits, (enc_out, cache), aux + dec_aux


def init_encdec_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                      *, device):
    """One ``{"self": {"attn": ring}}`` a decoder layer, on ``device``;
    ``decode_step`` adds each layer's ``"cross_kv"``."""
    return [{"self": {"attn": init_kv_cache(cfg, batch, max_len, True,
                                            dtype, device=device)}}
            for _ in range(cfg.num_layers)]


def encdec_loss(params, cfg, batch):
    """Next-token cross-entropy of the decoder. batch: ``{"tokens": (B, S),
    "embeds": (B, T, E)}``. Returns (loss + aux, {"loss", "aux_loss"})."""
    tokens = batch["tokens"]
    logits, _, aux = encdec_apply(params, cfg, tokens, batch["embeds"])
    loss = cross_entropy(logits[:, :-1], tokens[:, 1:]).mean()
    return loss + aux, {"loss": loss, "aux_loss": aux}
