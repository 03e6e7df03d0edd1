"""Config system: one dataclass family covering every assigned architecture.

A copy of the JAX package's ``configs/base.py`` (the port keeps its own so
that it imports nothing of that package). All configs are frozen
dataclasses, hashable and compared structurally.
``repro_torch.configs.get_config(name)`` returns the full-size published
config; ``reduced(cfg)`` returns a tiny same-family config for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionConfig:
    """Self-attention variants: GQA (optionally sliding-window) and MLA."""

    kind: str = "gqa"  # "gqa" | "mla"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    qkv_bias: bool = False  # Qwen2 uses bias on QKV projections
    rope_theta: float = 10_000.0
    # Sliding-window attention (gemma3-style): window size for local layers,
    # and every `global_every`-th layer is global (full) attention.
    sliding_window: Optional[int] = None
    global_every: int = 0  # 0 => all layers share `sliding_window` (or full)
    # MLA (DeepSeek-V2) parameters.
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    def is_global_layer(self, layer_idx: int) -> bool:
        if self.sliding_window is None:
            return True
        if self.global_every <= 0:
            return False
        # gemma3 pattern: layers (global_every-1, 2*global_every-1, ...) global.
        return (layer_idx + 1) % self.global_every == 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block parameters."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 128
    ngroups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class MoEConfig:
    """MoE layer config — covers the paper's Soft MoE, the sparse baselines
    (Tokens Choice / Experts Choice) and the fixed-routing ablations."""

    # "soft" | "tokens_choice" | "experts_choice" |
    # "identity" | "uniform" | "soft_uniform" | "uniform_soft"
    variant: str = "soft"
    num_experts: int = 8
    expert_d_ff: int = 0  # 0 => use model d_ff
    num_shared_experts: int = 0  # DeepSeek-style always-on experts
    # Soft MoE
    slots_per_expert: int = 1
    # Tokens Choice
    top_k: int = 2
    bpr: bool = True  # Batch Priority Routing (Riquelme et al. 2021)
    # Experts Choice / Tokens Choice capacity
    capacity_factor: float = 1.0
    # Aux losses (sparse variants only; Soft MoE needs none — balanced by
    # construction, which is part of the paper's point).
    aux_loss_weight: float = 0.01
    router_z_loss_weight: float = 1e-3
    # Router group size in sequences (sparse variants; paper §3.5).
    group_size: int = 1
    # Escape hatch: force the training-time batch-coupled group routing
    # (groups of `group_size` sequences compete for per-call capacity
    # buffers) in EVERY mode, serving included. Default False: serving
    # modes ("prefill"/"decode") route each row's tokens independently
    # and droplessly, so a request's outputs never depend on batch
    # composition, chunking, or speculative lookahead (the batch-invariant
    # serving contract; docs/serving.md). Training batches are
    # fixed-composition, so mode="train" always uses the coupled group
    # routing regardless of this flag — the paper's training setup is
    # unchanged.
    batch_coupled: bool = False
    # Fused Pallas kernel policy (Soft MoE, use_kernel=True; see
    # repro.kernels.tuning). 0 = derive block sizes from the (m, d, S)
    # heuristic table; set explicitly to pin a tiling (or autotune).
    kernel_block_tokens: int = 0
    kernel_block_slots: int = 0
    kernel_acc_dtype: str = "float32"  # accumulator/softmax-stat dtype

    def total_slots(self) -> int:
        return self.num_experts * self.slots_per_expert


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB (vlm / audio): input_specs() supplies
    precomputed patch/frame embeddings of dimension `embed_dim` and length
    `num_embeds`, which are linearly projected and prepended / encoded."""

    kind: str = "none"  # "none" | "vision" | "audio"
    embed_dim: int = 0
    num_embeds: int = 0


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    # "dense" | "ssm" | "hybrid" | "moe" | "vlm" | "audio" | "vit"
    family: str = "dense"
    num_layers: int = 2
    d_model: int = 128
    d_ff: int = 512
    vocab_size: int = 1024
    max_seq_len: int = 8192
    attention: Optional[AttentionConfig] = None
    ssm: Optional[SSMConfig] = None
    moe: Optional[MoEConfig] = None
    # Which layer indices carry the MoE block ("" = none, "all", "second_half",
    # or comma-separated indices). Paper default: second half of MLP blocks.
    moe_layers: str = ""
    # Hybrid (Hymba): attention and SSM run in PARALLEL inside one block and
    # their outputs are mean-fused.
    hybrid_parallel: bool = False
    # Encoder-decoder (Seamless): number of encoder layers (0 = decoder-only).
    encoder_layers: int = 0
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    act: str = "silu"  # "silu" | "gelu"
    # "gated" (SwiGLU: 3 matmuls, LLM-style) | "classic" (2 matmuls,
    # fc1-act-fc2 — the paper's ViT MLP/expert shape; gives the published
    # 933M for soft-moe-s/16-128e where gated would give 1378M)
    mlp_style: str = "gated"
    tie_embeddings: bool = False
    causal: bool = True
    # Training-time numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    logits_softcap: float = 0.0  # gemma-style final-logit softcap

    # -- derived helpers ---------------------------------------------------
    def moe_layer_indices(self) -> Tuple[int, ...]:
        if not self.moe_layers or self.moe is None:
            return ()
        if self.moe_layers == "all":
            return tuple(range(self.num_layers))
        if self.moe_layers == "second_half":
            return tuple(range(self.num_layers // 2, self.num_layers))
        return tuple(int(i) for i in self.moe_layers.split(","))

    def has_attention(self) -> bool:
        return self.attention is not None

    def has_ssm(self) -> bool:
        return self.ssm is not None

    def supports_long_context(self) -> bool:
        """True if decode at 500k tokens is sub-quadratic / bounded-state."""
        if self.ssm is not None and self.attention is None:
            return True  # pure SSM
        if self.hybrid_parallel:
            return True  # SSM path + (sliding-window) attention
        return False

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS=6ND)."""
        d = self.d_model
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d  # unembedding
        n_dec = self.num_layers
        total += self._stack_params(n_dec, cross_attention=self.encoder_layers > 0)
        if self.encoder_layers:
            total += self._stack_params(self.encoder_layers, cross_attention=False)
        if self.frontend.kind != "none":
            total += self.frontend.embed_dim * d  # projection stub
        return total

    def _attn_params(self) -> int:
        a = self.attention
        if a is None:
            return 0
        d = self.d_model
        if a.kind == "mla":
            qk_head = a.qk_nope_head_dim + a.qk_rope_head_dim
            p = d * a.kv_lora_rank  # kv down-proj
            p += d * a.qk_rope_head_dim  # decoupled k_rope proj
            p += a.kv_lora_rank * a.num_heads * (a.qk_nope_head_dim + a.v_head_dim)
            if a.q_lora_rank:
                p += d * a.q_lora_rank + a.q_lora_rank * a.num_heads * qk_head
            else:
                p += d * a.num_heads * qk_head
            p += a.num_heads * a.v_head_dim * d  # out proj
            return p
        q = d * a.num_heads * a.head_dim
        kv = 2 * d * a.num_kv_heads * a.head_dim
        o = a.num_heads * a.head_dim * d
        b = (a.num_heads + 2 * a.num_kv_heads) * a.head_dim if a.qkv_bias else 0
        return q + kv + o + b

    def _ssm_params(self) -> int:
        s = self.ssm
        if s is None:
            return 0
        d = self.d_model
        di = s.d_inner(d)
        nh = s.num_heads(d)
        p = d * (2 * di + 2 * s.ngroups * s.state_dim + nh)  # in_proj (z,x,B,C,dt)
        p += s.conv_width * (di + 2 * s.ngroups * s.state_dim)  # conv1d
        p += nh * 2 + di  # A_log, D, dt_bias... (approx: nh + nh + di norm)
        p += di * d  # out_proj
        return p

    def _mlp_params(self, d_ff: int) -> int:
        n_mats = 3 if self.mlp_style == "gated" else 2
        return n_mats * self.d_model * d_ff

    def _moe_params(self) -> int:
        m = self.moe
        assert m is not None
        dff = m.expert_d_ff or self.d_ff
        p = m.num_experts * self._mlp_params(dff)
        p += m.num_shared_experts * self._mlp_params(dff)
        if m.variant == "soft":
            p += self.d_model * m.total_slots() + 1  # Phi + scale
        else:
            p += self.d_model * m.num_experts  # router
        return p

    def _stack_params(self, n_layers: int, cross_attention: bool) -> int:
        moe_idx = set(self.moe_layer_indices())
        total = 0
        for i in range(n_layers):
            total += self._attn_params()
            if cross_attention:
                total += self._attn_params()
            total += self._ssm_params()
            if self.moe is not None and i in moe_idx:
                total += self._moe_params()
            elif self.d_ff > 0:
                total += self._mlp_params(self.d_ff)
            total += 2 * self.d_model  # norms
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed-active experts count)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        dff = m.expert_d_ff or self.d_ff
        if m.variant == "soft":
            # FLOPs governed by slot count; at slots≈tokens this is ~1 expert
            # per token-equivalent: count top_k=1 expert equivalent.
            active_e = max(1, m.total_slots() * 0 + 1)
        else:
            active_e = m.top_k
        per_layer_inactive = (m.num_experts - active_e - m.num_shared_experts)
        dead = len(self.moe_layer_indices()) * per_layer_inactive * self._mlp_params(dff)
        return self.param_count() - max(dead, 0)


# ---------------------------------------------------------------------------
# Input-shape registry (assigned shapes; identical across LM archs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """Whether (arch, shape) is a valid dry-run cell, with skip reason."""
    if shape == "long_500k" and not cfg.supports_long_context():
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is full-attention (see DESIGN.md §5)"
        )
    return True, ""


# ---------------------------------------------------------------------------
# Reduced configs for smoke tests
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config: runs a fwd/train step on CPU in seconds."""
    attn = cfg.attention
    if attn is not None:
        heads = min(attn.num_heads, 4)
        ratio = max(1, attn.num_heads // max(attn.num_kv_heads, 1))
        kv = max(1, heads // min(ratio, heads))
        attn = dataclasses.replace(
            attn,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            kv_lora_rank=16 if attn.kind == "mla" else 0,
            q_lora_rank=0,
            qk_rope_head_dim=8 if attn.kind == "mla" else 0,
            qk_nope_head_dim=8 if attn.kind == "mla" else 0,
            v_head_dim=16 if attn.kind == "mla" else 0,
            sliding_window=16 if attn.sliding_window else None,
        )
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(
            ssm, state_dim=16, head_dim=8, chunk_size=16, conv_width=4
        )
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe,
            num_experts=min(moe.num_experts, 4),
            expert_d_ff=32,
            top_k=min(moe.top_k, 2),
            num_shared_experts=min(moe.num_shared_experts, 1),
        )
    d_model = 64
    if ssm is not None:
        d_model = max(d_model, ssm.head_dim * 4 * 2 // ssm.expand)
    if attn is not None:
        d_model = max(d_model, attn.num_heads * 4)
    return dataclasses.replace(
        cfg,
        num_layers=max(2, min(4, cfg.num_layers)),
        d_model=d_model,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        max_seq_len=128,
        attention=attn,
        ssm=ssm,
        moe=moe,
        moe_layers="second_half" if cfg.moe_layers else "",
        encoder_layers=2 if cfg.encoder_layers else 0,
        frontend=dataclasses.replace(cfg.frontend, embed_dim=32, num_embeds=8)
        if cfg.frontend.kind != "none"
        else cfg.frontend,
        scan_layers=False,
        remat=False,
    )
