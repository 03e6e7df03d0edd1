"""Shared layer plumbing. Params are plain dicts of tensors; every layer
exposes ``init(generator, cfg, ...) -> params`` and
``apply(params, cfg, x, ...) -> y`` functions (counterpart of
``repro/layers/common.py``). Randomness comes from an explicit
``torch.Generator``; tensors are made on the generator's device."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dtype_of(name) -> torch.dtype:
    """'bfloat16' -> torch.bfloat16 (torch dtypes pass through)."""
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. Raises when CUDA is asked for
    and no card is visible: the port never falls back to the CPU on its
    own, only when the caller passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device "
            "(pass device='cpu' to run the plain PyTorch path)"
        )
    return dev


def truncated_normal(gen: torch.Generator, shape, stddev,
                     dtype=torch.float32) -> torch.Tensor:
    """``stddev`` times a standard normal truncated to [-2, 2] (not
    renormalised), as ``jax.random.truncated_normal(rng, -2, 2, ...)``
    draws it: inverse-CDF sampling of a uniform on [Phi(-2), Phi(2)]."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.empty(shape, dtype=torch.float32, device=gen.device)
    u.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=gen)
    x = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return (x * stddev).to(dtype)


def lecun_init(gen: torch.Generator, shape, fan_in=None,
               dtype=torch.float32) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    return truncated_normal(gen, shape, (1.0 / max(fan_in, 1)) ** 0.5, dtype)


def cast(x: torch.Tensor, dtype_str) -> torch.Tensor:
    return x.to(dtype_of(dtype_str))


# --- normalization ----------------------------------------------------------


def norm_init(cfg, d: int, device=None):
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    return {"scale": torch.ones(d, device=device)}


def _mean_sq(x: torch.Tensor) -> torch.Tensor:
    """Mean of squares accumulated in f32, keepdim."""
    xf = x.float()
    return (xf * xf).sum(-1, keepdim=True) / x.shape[-1]


def norm_apply(params, cfg, x: torch.Tensor, eps: float = 1e-6):
    """Stats in f32, application in the compute dtype (bf16-safe)."""
    dtype = x.dtype
    if cfg.norm == "layernorm":
        mu = x.float().sum(-1, keepdim=True) / x.shape[-1]
        xc = x - mu.to(dtype)
        inv = torch.rsqrt(_mean_sq(xc) + eps).to(dtype)
        y = xc * inv
        return y * params["scale"].to(dtype) + params["bias"].to(dtype)
    inv = torch.rsqrt(_mean_sq(x) + eps).to(dtype)
    return x * inv * params["scale"].to(dtype)


def l2_normalize(x: torch.Tensor, axis: int, eps: float = 1e-6):
    """Paper Algorithm 2: x / (||x|| + eps). The eps is added to the norm
    (not a max with it), as the JAX package does."""
    norm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    return x * torch.reciprocal(norm + eps)


# --- activations ------------------------------------------------------------


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]
