"""The 10 assigned architectures, exact published configs.

A copy of the JAX package's ``configs/archs.py``. Sources are cited
per-arch.
"""
from __future__ import annotations

from .base import (
    AttentionConfig,
    FrontendConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)

# --- dense GQA decoders -----------------------------------------------------

# [arXiv:2407.10671; hf] Qwen2-72B: GQA with QKV bias.
QWEN2_72B = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    d_ff=29568,
    vocab_size=152064,
    max_seq_len=131072,
    attention=AttentionConfig(
        kind="gqa", num_heads=64, num_kv_heads=8, head_dim=128,
        qkv_bias=True, rope_theta=1e6,
    ),
    tie_embeddings=False,
)

# [arXiv:2407.10671; hf] Qwen2-0.5B.
QWEN2_0_5B = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    d_ff=4864,
    vocab_size=151936,
    max_seq_len=131072,
    attention=AttentionConfig(
        kind="gqa", num_heads=14, num_kv_heads=2, head_dim=64,
        qkv_bias=True, rope_theta=1e6,
    ),
    tie_embeddings=True,
)

# [arXiv:2407.21783] Llama-3-8B: GQA, 128k vocab.
LLAMA3_8B = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=128256,
    max_seq_len=131072,
    attention=AttentionConfig(
        kind="gqa", num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=5e5,
    ),
)

# [hf:google/gemma-3] Gemma3-27B: 5:1 local:global sliding-window attention.
GEMMA3_27B = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    d_ff=21504,
    vocab_size=262144,
    max_seq_len=131072,
    attention=AttentionConfig(
        kind="gqa", num_heads=32, num_kv_heads=16, head_dim=128,
        rope_theta=1e6, sliding_window=1024, global_every=6,
    ),
    tie_embeddings=True,
    logits_softcap=30.0,
    act="gelu",
)

# [hf:mistralai/Pixtral-12B-2409] Pixtral-12B: pixtral-ViT frontend (STUB:
# input_specs() supplies precomputed patch embeddings) + mistral-nemo decoder.
PIXTRAL_12B = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    d_ff=14336,
    vocab_size=131072,
    max_seq_len=131072,
    attention=AttentionConfig(
        kind="gqa", num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=1e9,
    ),
    frontend=FrontendConfig(kind="vision", embed_dim=1024, num_embeds=256),
)

# [arXiv:2405.21060] Mamba2-370m: pure SSD, attention-free, d_ff=0.
MAMBA2_370M = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    d_ff=0,
    vocab_size=50280,
    max_seq_len=1048576,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=128),
    tie_embeddings=True,
    norm="rmsnorm",
)

# [arXiv:2411.13676; hf] Hymba-1.5B: parallel attention + mamba heads per
# block, mean-fused; sliding-window attention on most layers.
HYMBA_1_5B = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    d_ff=5504,
    vocab_size=32001,
    max_seq_len=1048576,
    attention=AttentionConfig(
        kind="gqa", num_heads=25, num_kv_heads=5, head_dim=64,
        sliding_window=1024, global_every=16,
    ),
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, conv_width=4,
                  chunk_size=128),
    hybrid_parallel=True,
)

# [arXiv:2405.04434; hf] DeepSeek-V2-Lite (16B total): MLA kv_lora=512,
# 2 shared + 64 routed experts top-6, expert d_ff=1408, first layer dense.
DEEPSEEK_V2_LITE = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    d_ff=10944,  # dense layers' MLP width
    vocab_size=102400,
    max_seq_len=163840,
    attention=AttentionConfig(
        kind="mla", num_heads=16, num_kv_heads=16, head_dim=192,
        kv_lora_rank=512, q_lora_rank=0,
        qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
    ),
    moe=MoEConfig(
        variant="tokens_choice", num_experts=64, expert_d_ff=1408,
        num_shared_experts=2, top_k=6, capacity_factor=1.0, bpr=False,
    ),
    moe_layers=",".join(str(i) for i in range(1, 27)),  # all but layer 0
)

# [hf:ibm-granite/granite-3.0-1b-a400m-base] Granite MoE: 32 experts top-8.
GRANITE_MOE_1B = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    d_ff=512,
    vocab_size=49155,
    max_seq_len=8192,
    attention=AttentionConfig(
        kind="gqa", num_heads=16, num_kv_heads=8, head_dim=64,
    ),
    moe=MoEConfig(
        variant="tokens_choice", num_experts=32, expert_d_ff=512,
        top_k=8, capacity_factor=1.0, bpr=False,
    ),
    moe_layers="all",
    tie_embeddings=True,
)

# [arXiv:2308.11596] SeamlessM4T-large-v2 backbone: encoder-decoder; audio
# frontend STUB (input_specs() supplies precomputed frame embeddings).
SEAMLESS_M4T_LARGE = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,  # decoder layers
    encoder_layers=24,
    d_model=1024,
    d_ff=8192,
    vocab_size=256206,
    max_seq_len=8192,
    attention=AttentionConfig(
        kind="gqa", num_heads=16, num_kv_heads=16, head_dim=64,
    ),
    frontend=FrontendConfig(kind="audio", embed_dim=1024, num_embeds=512),
    norm="layernorm",
    act="gelu",
)

ASSIGNED = (
    QWEN2_72B,
    QWEN2_0_5B,
    LLAMA3_8B,
    GEMMA3_27B,
    PIXTRAL_12B,
    MAMBA2_370M,
    HYMBA_1_5B,
    DEEPSEEK_V2_LITE,
    GRANITE_MOE_1B,
    SEAMLESS_M4T_LARGE,
)
