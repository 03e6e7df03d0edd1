"""Rotary position embeddings (llama-style half rotation), counterpart of
``repro/layers/rotary.py``."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = (torch.arange(0, head_dim, 2, dtype=torch.float32,
                              device=device) / head_dim)
    return 1.0 / (theta ** exponents)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq). Rotation in f32, result in x's dtype."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., :, None].to(torch.float32) * inv  # (..., seq, hd/2)
    cos = torch.cos(ang)[..., :, None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
