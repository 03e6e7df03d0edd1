"""Single-sequence oracle of the Soft-MoE kernels (the paper's Algorithm 1
with the Algorithm 2 L2 norm), counterpart of ``repro/kernels/ref.py``.

One sequence at a time is the per-sequence routing invariant stated as an
API: dispatch normalizes over this sequence's m tokens, combine over its
S slots. Every batched implementation (the CUDA kernels, their plain
versions, the einsum path of ``core/soft_moe.py``) must agree row for
row with these functions applied to each row alone.
"""
from __future__ import annotations

import torch

from ..layers.common import l2_normalize


def normalized_phi(phi: torch.Tensor, scale) -> torch.Tensor:
    """scale * l2norm(Phi) over d (axis 0). phi: (d, S)."""
    return scale * l2_normalize(phi, axis=0)


def logits_ref(x: torch.Tensor, phi_n: torch.Tensor) -> torch.Tensor:
    """x: (m, d) raw tokens; phi_n: (d, S) pre-normalized slot params."""
    xn = l2_normalize(x.float(), axis=1)
    return xn @ phi_n.float()  # (m, S)


def dispatch_ref(x: torch.Tensor, phi_n: torch.Tensor) -> torch.Tensor:
    """Slots (S, d): X~ = D^T X with D softmaxed over tokens."""
    d_w = torch.softmax(logits_ref(x, phi_n), dim=0)  # per slot, over tokens
    return (d_w.T @ x.float()).to(x.dtype)


def combine_ref(x: torch.Tensor, phi_n: torch.Tensor,
                ys: torch.Tensor) -> torch.Tensor:
    """y (m, d): Y = C Ys with C softmaxed over slots; ys: (S, d)."""
    c_w = torch.softmax(logits_ref(x, phi_n), dim=1)  # per token, over slots
    return (c_w @ ys.float()).to(x.dtype)


def soft_moe_ref(x, phi, scale, expert_fn):
    """The whole layer for one sequence: phi (d, S), expert_fn maps the
    slots (S, d) to the expert outputs (S, d)."""
    phi_n = normalized_phi(phi, scale)
    return combine_ref(x, phi_n, expert_fn(dispatch_ref(x, phi_n)))
