"""Decoder-only LM, the dense, MoE, vlm, SSM and hybrid families with
GQA or MLA attention and Mamba-2 (SSD) layers, counterpart of
``repro/models/lm.py``; its transformer block also carries the MoE
layers of the ViT (``models/vit.py``).

Params hold one dict per layer under ``"layers"``; the JAX package stacks
the layers of each homogeneous segment on a leading axis instead
(``convert.params_from_jax`` splits them). The port runs every layer in
a Python loop. In train mode with ``cfg.scan_layers`` it follows the JAX
package's scan path: with ``cfg.remat`` each block runs under activation
checkpointing (``torch.utils.checkpoint``), and the telemetry of a
segment is stacked on a leading ``(count,)`` axis and keyed by the
segment's first layer; otherwise (serving, or ``scan_layers`` off, as
``reduced`` sets it) each layer's telemetry is keyed by its index, as
the JAX unrolled path keys it. The vision and audio frontends are the
reference's stub: precomputed patch or frame embeddings projected by
``params["frontend"]`` and prepended to the tokens (here an
encoder-decoder config runs its decoder stack, as the reference's
``lm_init``/``lm_apply`` do; ``models/encdec.py`` runs the whole model).
A block runs attention, a Mamba-2 layer (``layers/ssm.py``; mamba2 has
no attention and no MLP), or both in parallel with their outputs
mean-fused (Hymba). A cache is the per-layer list of ``init_cache``
(contiguous rings and SSM rows) or of the paged backend's pools, updated
in place. MoE layers run any
variant of ``core.moe_apply``: Soft MoE, the sparse baselines (whose
routing scope follows ``mode``: coupled groups in train mode, per-row
dropless routing when serving) and the ablations.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from torch.utils.checkpoint import checkpoint

from ..core import moe_apply, moe_init, resolve_moe_cfg
from ..layers.attention import attention_apply, attention_init, init_kv_cache
from ..layers.common import dtype_of, lecun_init, norm_apply, norm_init
from ..layers.embedding import embed, embedding_init, unembed
from ..layers.mlp import mlp_apply, mlp_init
from ..layers.ssm import init_ssm_cache, ssm_apply, ssm_init
from ..tracing import span


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
    """Raise for the parts of the config family the port lacks: an
    attention kind or a frontend that no config of the repo has."""
    missing = []
    if cfg.has_attention() and cfg.attention.kind not in ("gqa", "mla"):
        missing.append(f"{cfg.attention.kind!r} attention")
    if cfg.frontend.kind not in ("none", "vision", "audio"):
        missing.append(f"the {cfg.frontend.kind} frontend")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(missing)}")


def block_init(gen: torch.Generator, cfg, is_moe: bool = False):
    d = cfg.d_model
    dev = gen.device
    p = {"norm1": norm_init(cfg, d, dev)}
    if cfg.has_attention():
        p["attn"] = attention_init(gen, cfg)
    if cfg.has_ssm():
        p["ssm"] = ssm_init(gen, cfg)
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
                block_tables=None, paged_kernel: bool = False,
                telemetry: bool = False):
    """Returns (y, cache, aux), or (y, cache, aux, telem) with
    ``telemetry``. ``is_moe`` runs the block's MLP as a MoE layer of the
    config's variant (``use_kernel`` routes a Soft-MoE layer through the
    routing and combine kernels);
    aux is its auxiliary loss (the float 0.0 otherwise, so a dense block
    launches nothing for it). ``block_tables`` (B, blocks_per_row)
    switches the attention cache to the paged block-pool layout;
    ``paged_kernel`` routes paged single-token decode through the paged
    decode-attention kernel. The cache dict holds ``"attn"`` and/or
    ``"ssm"`` (the slot rows of ``layers/ssm.py``); a hybrid block's
    attention and SSM outputs are averaged. ``telem`` holds detached f32
    scalars: the residual RMS, the attention output's absmax (with
    attention) and, on a MoE block, the layer's routing health under
    ``"moe"``; the block's output is the same bitwise either way."""
    aux = 0.0
    new_cache = None if cache is None else {}
    xn = norm_apply(params["norm1"], cfg, x)
    a_out = mix = None
    if cfg.has_attention():
        a_out, a_cache = attention_apply(
            params["attn"], cfg, xn, layer_is_global=is_global,
            positions=positions,
            cache=None if cache is None else cache.get("attn"),
            mode=mode, block_tables=block_tables, paged_kernel=paged_kernel,
        )
        mix = a_out
        if new_cache is not None:
            new_cache["attn"] = a_cache
    if cfg.has_ssm():
        s_out, s_cache = ssm_apply(
            params["ssm"], cfg, xn,
            cache=None if cache is None else cache.get("ssm"), mode=mode,
            positions=positions)
        if mix is None:
            mix = s_out
        elif cfg.hybrid_parallel:
            mix = (mix + s_out) * 0.5  # Hymba: mean-fuse the parallel heads
        else:
            mix = mix + s_out
        if new_cache is not None:
            new_cache["ssm"] = s_cache
    x = x + mix
    moe_telem = None
    if "norm2" in params:
        xn = norm_apply(params["norm2"], cfg, x)
        if is_moe:
            m_out, metrics = moe_apply(
                params["moe"], resolve_moe_cfg(cfg.moe, cfg.d_ff), xn,
                cfg.act, use_kernel=use_kernel, telemetry=telemetry,
                mode=mode)
            aux = aux + metrics["moe_aux_loss"]
            moe_telem = metrics.get("telemetry")
        else:
            m_out = mlp_apply(params["mlp"], xn, cfg.act)
        x = x + m_out
    if not telemetry:
        return x, new_cache, aux
    telem = {
        "residual_rms": torch.sqrt(torch.mean(torch.square(
            x.detach().float()))),
    }
    if a_out is not None:
        telem["max_attn_out"] = a_out.detach().float().abs().max()
    if moe_telem is not None:
        telem["moe"] = moe_telem
    return x, new_cache, aux, telem


def _stack_telemetry(per_layer):
    """Per-layer telemetry dicts -> one dict of leaves stacked on a
    leading (count,) axis, as a JAX scan stacks its outputs."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _stack_telemetry([t[k] for t in per_layer])
                for k in first}
    return torch.stack(per_layer)


def _train_block(p, cfg, x, is_moe, is_global, positions, use_kernel,
                 telemetry, remat):
    """One block of the train-mode scan path: (y, aux, telem or None).
    Under ``remat`` the block runs under activation checkpointing, and its
    telemetry is taken in the forward only: the backward's recompute runs
    the block without it, so the routing-health kernel runs once per MoE
    layer per step (in JAX the recompute drops the stop_gradient'd
    telemetry that the backward does not need). The telemetry is detached
    and saves nothing for the backward, so both runs save the same
    tensors."""
    stash = []

    def body(h):
        out = block_apply(p, cfg, h, is_moe=is_moe, is_global=is_global,
                          positions=positions, mode="train",
                          use_kernel=use_kernel,
                          telemetry=telemetry and not stash)
        if len(out) == 4:
            stash.append(out[3])
        return out[0], out[2]

    y, aux = checkpoint(body, x, use_reentrant=False) if remat else body(x)
    return y, aux, stash[0] if stash else None


def _logit_probes(logits):
    """Per-row (B,) numerics of the logits, one row at a time (a row's
    softmax over the vocabulary is the largest temporary); the span
    ``lm/logit_probes``, with its device interval on CUDA under a
    profile."""
    with span("lm/logit_probes", device=logits.is_cuda):
        out = {"max_abs_logit": [], "softmax_entropy": [],
               "nonfinite_count": []}
        for lf in logits.detach().float():
            lse = torch.logsumexp(lf, dim=-1)
            ent = lse - (torch.softmax(lf, dim=-1) * lf).sum(-1)
            out["max_abs_logit"].append(lf.abs().max())
            out["softmax_entropy"].append(ent.mean())
            out["nonfinite_count"].append((~torch.isfinite(lf)).sum().float())
        return {k: torch.stack(v) for k, v in out.items()}


def lm_init(gen: torch.Generator, cfg):
    """Random parameters drawn from ``gen`` on its device, in f32 (the
    configs' ``param_dtype``). A config with a frontend also draws its
    projection ``params["frontend"]["w"]`` (embed_dim, d_model), after the
    embedding and before the layers; one without draws nothing for it."""
    check_supported(cfg)
    moe_idx = set(cfg.moe_layer_indices())
    params = {"embed": embedding_init(gen, cfg.vocab_size, cfg.d_model)}
    if cfg.frontend.kind != "none":
        fe = cfg.frontend.embed_dim
        params["frontend"] = {"w": lecun_init(gen, (fe, cfg.d_model),
                                              fan_in=fe)}
    params["layers"] = [block_init(gen, cfg, i in moe_idx)
                        for i in range(cfg.num_layers)]
    params["final_norm"] = norm_init(cfg, cfg.d_model, gen.device)
    if not cfg.tie_embeddings and cfg.vocab_size:
        params["unembed"] = embedding_init(gen, cfg.vocab_size, cfg.d_model)
    return params


def lm_apply(params, cfg, tokens, *, embeds=None, positions=None,
             cache=None, mode: str = "train", use_kernel: bool = False,
             last_only: bool = False, block_tables=None,
             paged_kernel: bool = False, telemetry: bool = False):
    """tokens: (B, S) int; embeds: (B, N, E) precomputed frontend
    embeddings (the vlm stub), projected and prepended to the token
    embeddings, so positions and logits run over N + S; positions: (S,)
    shared or (B, S) per-row (entries < 0 mark pad/inactive tokens that
    neither write nor read any cache). ``cache`` is the per-layer list of
    ``init_cache`` (rings and SSM rows), or of paged pools addressed
    through ``block_tables`` (B, blocks_per_row); either is updated in
    place. ``paged_kernel`` streams paged single-token decode through the
    kernel. ``use_kernel`` routes the Soft-MoE layers through
    the kernels.
    ``last_only`` unembeds only the final position. Returns (logits (B,
    S|1, V) f32, cache, aux), aux the sum of the blocks' auxiliary losses,
    plus ``telem`` with ``telemetry``: ``{"layers": {key: block telemetry},
    "logits": per-row probes}``, keyed by layer index, or on the
    train-mode scan path by segment start with leaves stacked (count,)."""
    check_supported(cfg)
    dt = dtype_of(cfg.dtype)
    x = embed(params["embed"], tokens, dt)
    if embeds is not None and "frontend" in params:
        fe = embeds.to(dt) @ params["frontend"]["w"].to(dt)
        x = torch.cat([fe, x], dim=1)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), device=x.device)
    layer_telem = {}
    scan = cache is None and cfg.scan_layers and mode == "train"
    remat = scan and cfg.remat and torch.is_grad_enabled()
    for start, count, is_moe in segment_plan(cfg):
        seg_telem = []
        for i in range(start, start + count):
            p = params["layers"][i]
            is_global = (cfg.attention.is_global_layer(i)
                         if cfg.has_attention() else True)
            if scan:
                x, a, t = _train_block(p, cfg, x, is_moe, is_global,
                                       positions, use_kernel, telemetry,
                                       remat)
                seg_telem.append(t)
            else:
                out = block_apply(
                    p, cfg, x, is_moe=is_moe, is_global=is_global,
                    positions=positions,
                    cache=None if cache is None else cache[i], mode=mode,
                    use_kernel=use_kernel, block_tables=block_tables,
                    paged_kernel=paged_kernel, telemetry=telemetry)
                x, a = out[0], out[2]
                if telemetry:
                    layer_telem[i] = out[3]
            aux = aux + a
        if telemetry and scan:
            layer_telem[start] = _stack_telemetry(seg_telem)
    if last_only:
        x = x[:, -1:]
    x = norm_apply(params["final_norm"], cfg, x)
    table = params["unembed"] if "unembed" in params else params["embed"]
    logits = unembed(table, x, cfg.logits_softcap)
    if not telemetry:
        return logits, cache, aux
    return logits, cache, aux, {"layers": layer_telem,
                                "logits": _logit_probes(logits)}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device):
    """The contiguous per-layer cache list on ``device``: ``"attn"`` a ring
    of ``max_len`` slots (``min(max_len, window)`` on local layers),
    ``"ssm"`` the recurrent rows; every leaf has a leading ``batch`` axis
    and the rings a per-row ``pos``, so rows are admitted and retired
    independently (``serve/cache_pool.py``)."""
    caches = []
    for i in range(cfg.num_layers):
        c = {}
        if cfg.has_attention():
            c["attn"] = init_kv_cache(cfg, batch, max_len,
                                      cfg.attention.is_global_layer(i),
                                      dtype, device=device)
        if cfg.has_ssm():
            c["ssm"] = init_ssm_cache(cfg, batch, dtype, device=device)
        caches.append(c)
    return caches


def lm_loss(params, cfg, batch, use_kernel: bool = False,
            telemetry: bool = False):
    """Next-token cross-entropy. batch: {"tokens": (B, S)[, "embeds",
    "loss_mask"]}; frontend embeds prepend non-text positions, and only
    the text is scored. Returns (loss + aux, {"loss", "aux_loss"[,
    "telemetry"]}); the telemetry tree of ``lm_apply`` leaves the loss
    unchanged."""
    tokens = batch["tokens"]
    out = lm_apply(params, cfg, tokens, embeds=batch.get("embeds"),
                   mode="train", use_kernel=use_kernel, telemetry=telemetry)
    logits, _, aux = out[:3]
    logits = logits[:, logits.shape[1] - tokens.shape[1]:]
    nll = cross_entropy(logits[:, :-1], tokens[:, 1:])
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:].float()
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        loss = nll.mean()
    metrics = {"loss": loss, "aux_loss": aux}
    if telemetry:
        metrics["telemetry"] = out[3]
    return loss + aux, metrics


def cross_entropy(logits, targets):
    """Per-token lse(logits) - logits[target], in f32."""
    logits = logits.float()
    picked = logits.gather(-1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked
