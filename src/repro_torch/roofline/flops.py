"""Analytic FLOP / HBM-byte model per (arch × shape), counterpart of
``repro/roofline/flops.py`` line for line: the napkin math the roofline
is anchored on. Plain arithmetic over the port's configs copy.

The models below count matmul FLOPs per layer from the config (exact for
the dominant terms; elementwise ignored), are cross-checked against
``torch.utils.flop_counter.FlopCounterMode`` on the port's decode
forward (``tests/test_torch_roofline.py``; the reference checks its
unrolled HLO), and scale with documented assumptions:

  * train FLOPs = fwd × (1 + 2 [bwd] + 1 [full remat recompute]).
  * HBM bytes = param traffic (bf16 reads × passes + fp32 optimizer r/w)
    + layer-boundary activation traffic + attention KV/cache traffic +
    logits. Perfect sharding assumed (global / chips).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..configs import SHAPES


def _attn_flops(cfg, t: int, ctx: float, is_global: bool) -> float:
    a = cfg.attention
    d = cfg.d_model
    if a.kind == "mla":
        dn, dr, dv, r, h = (
            a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim,
            a.kv_lora_rank, a.num_heads,
        )
        f = 2 * t * d * h * (dn + dr)  # q proj
        f += 2 * t * d * r + 2 * t * d * dr  # kv down + krope
        f += 2 * t * h * dn * r  # q absorb
        f += 2 * t * h * ctx * (r + dr)  # scores (latent)
        f += 2 * t * h * ctx * r  # weighted latent
        f += 2 * t * h * r * dv  # uv expand
        f += 2 * t * h * dv * d  # out proj
        return f
    h, g, hd = a.num_heads, a.num_kv_heads, a.head_dim
    if a.sliding_window is not None and not is_global:
        ctx = min(ctx, a.sliding_window)
    f = 2 * t * d * h * hd  # q
    f += 2 * 2 * t * d * g * hd  # k, v
    f += 2 * t * h * hd * d  # o
    f += 2 * 2 * t * h * hd * ctx  # qk + av
    return f


def _ssm_flops(cfg, t: int) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.num_heads(d)
    gn = s.ngroups * s.state_dim
    f = 2 * t * d * (2 * di + 2 * gn + nh)  # z,x,B,C,dt projections
    f += 2 * t * (di + 2 * gn) * s.conv_width  # causal conv
    L, n, dh = s.chunk_size, s.state_dim, s.head_dim
    # SSD: intra-chunk scores + mix, chunk states, inter-chunk outputs
    f += t * nh * (2 * L * n + 2 * L * dh + 4 * n * dh)
    f += 2 * t * di * d  # out proj
    return f


def _mlp_flops(cfg, t: int, d_ff: int) -> float:
    return 6 * t * cfg.d_model * d_ff


def _moe_flops(cfg, b: int, s: int) -> float:
    m = cfg.moe
    d = cfg.d_model
    ffe = m.expert_d_ff or cfg.d_ff
    t = b * s
    if m.variant == "soft" or m.variant in (
        "identity", "uniform", "soft_uniform", "uniform_soft"
    ):
        ns = m.total_slots()
        f = 6 * t * d * ns  # logits + dispatch mix + combine mix
        f += b * ns * 6 * d * ffe  # experts on slots
    else:
        f = 2 * t * d * m.num_experts  # router
        f += 6 * t * m.top_k * d * ffe  # routed experts
    f += 6 * t * d * ffe * m.num_shared_experts
    return f


def fwd_flops(cfg, batch: int, seq: int, mode: str,
              cache_len: int = 0) -> float:
    """One forward pass, global (all chips)."""
    t = batch * seq
    if mode == "train" or mode == "prefill":
        ctx = seq / 2 if cfg.causal else seq  # causal average
    else:
        ctx = cache_len
    moe_idx = set(cfg.moe_layer_indices())
    total = 0.0
    for i in range(cfg.num_layers):
        is_global = (
            cfg.attention.is_global_layer(i) if cfg.attention else True
        )
        if cfg.has_attention():
            total += _attn_flops(cfg, t, ctx, is_global)
        if cfg.has_ssm():
            total += _ssm_flops(cfg, t)
        if cfg.moe is not None and i in moe_idx:
            total += _moe_flops(cfg, batch, seq)
        elif cfg.d_ff > 0:
            total += _mlp_flops(cfg, t, cfg.d_ff)
    if cfg.encoder_layers:
        te = batch * cfg.frontend.num_embeds
        if mode != "decode":
            # encoder runs once (at train/prefill); decode reuses enc_out
            for i in range(cfg.encoder_layers):
                total += _attn_flops(cfg, te, cfg.frontend.num_embeds, True)
                if cfg.d_ff > 0:
                    total += _mlp_flops(cfg, te, cfg.d_ff)
        # cross attention in every decoder layer (kv cached at decode)
        a = cfg.attention
        kv_flops = 2 * 2 * te * cfg.d_model * a.num_kv_heads * a.head_dim
        total += cfg.num_layers * (
            2 * t * cfg.d_model * a.num_heads * a.head_dim * 2  # q,o
            + (0 if mode == "decode" else kv_flops)
            + 2 * 2 * t * a.num_heads * a.head_dim * cfg.frontend.num_embeds
        )
    if cfg.frontend.kind != "none":
        total += 2 * batch * cfg.frontend.num_embeds * (
            cfg.frontend.embed_dim * cfg.d_model
        )
    if cfg.vocab_size:
        # prefill/decode unembed only the final position per sequence
        t_un = t if mode == "train" else batch
        total += 2 * t_un * cfg.d_model * cfg.vocab_size
    return total


@dataclass
class AnalyticCost:
    flops_global: float
    bytes_global: float
    notes: str = ""

    def per_device(self, chips: int):
        return self.flops_global / chips, self.bytes_global / chips


def _param_bytes(cfg) -> float:
    return float(cfg.param_count())


def _cache_bytes(cfg, batch: int, length: int) -> float:
    a = cfg.attention
    total = 0.0
    for i in range(cfg.num_layers):
        if a is not None:
            ln = length
            if a.sliding_window is not None and not a.is_global_layer(i):
                ln = min(length, a.sliding_window)
            if a.kind == "mla":
                total += batch * ln * (a.kv_lora_rank + a.qk_rope_head_dim) * 2
            else:
                total += batch * ln * 2 * a.num_kv_heads * a.head_dim * 2
        if cfg.ssm is not None:
            s = cfg.ssm
            total += batch * s.num_heads(cfg.d_model) * s.head_dim * \
                s.state_dim * 4
    return total


def analytic_cost(cfg, shape_name: str) -> AnalyticCost:
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    p = _param_bytes(cfg)
    d = cfg.d_model
    if shape.mode == "train":
        f_fwd = fwd_flops(cfg, b, s, "train")
        remat = 1.0 if cfg.remat else 0.0
        flops = f_fwd * (3.0 + remat)
        t = b * s
        bytes_ = (
            p * 2 * 3  # bf16 param reads: fwd + bwd + remat
            + p * 4 * 2 * 3  # fp32 master+moments read/write in optimizer
            + cfg.num_layers * t * d * 2 * 6  # layer-boundary activations
            + t * cfg.vocab_size * 4 * 2  # logits write+read (loss)
        )
        return AnalyticCost(flops, bytes_, "train: fwd+bwd+remat")
    if shape.mode == "prefill":
        flops = fwd_flops(cfg, b, s, "prefill")
        t = b * s
        bytes_ = p * 2 + cfg.num_layers * t * d * 2 * 2 + _cache_bytes(
            cfg, b, s
        )
        return AnalyticCost(flops, bytes_, "prefill: 1 fwd + cache write")
    # decode: one token, full cache read
    flops = fwd_flops(cfg, b, 1, "decode", cache_len=s)
    bytes_ = p * 2 + _cache_bytes(cfg, b, s) + b * cfg.vocab_size * 4
    return AnalyticCost(flops, bytes_, "decode: params + cache read / token")
