"""Token embedding / unembedding, counterpart of
``repro/layers/embedding.py``."""
from __future__ import annotations

import torch

from .common import truncated_normal


def embedding_init(gen: torch.Generator, vocab_size: int, d_model: int):
    return {"table": truncated_normal(gen, (vocab_size, d_model), 0.02)}


def embed(params, tokens: torch.Tensor, dtype: torch.dtype):
    return params["table"].to(dtype)[tokens]


def unembed(params, x: torch.Tensor, softcap: float = 0.0):
    """Logits in f32 against the table in f32; gemma-style softcap."""
    logits = x.to(torch.float32) @ params["table"].to(torch.float32).T
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
