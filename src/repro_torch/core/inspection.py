"""Model inspection (paper section 5, Fig. 9 / App. G): statistics of the
learned dispatch and combine weights, counterpart of
``repro/core/inspection.py``.

  * token_contributions: the total dispatch weight each token sends to
    all slots (Fig. 9 left; no token at zero means no dropping).
  * expert_importance: per-slot combine mass summed over tokens,
    normalized by its min (Fig. 9 middle).
  * cumulative_slot_weight: how many tokens cover a given fraction of a
    slot's dispatch mass (Fig. 9 right).

``method="dense"`` materializes the (b, m, n p) weights through
``soft_moe_weights`` (the oracle); ``method="chunked"`` streams token
chunks against per-slot and per-token softmax (max, denom) stats, the
residuals the kernels save, at O(chunk S) memory.
``routing_health_from_stats`` is the chunked plain-torch twin of
``kernels.ops.routing_health`` (K6); the tests hold them together.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..layers.common import l2_normalize
from .soft_moe import _dense_routing_health, soft_moe_weights


def streaming_softmax_stats(x, phi_n, chunk_tokens: int = 512):
    """Per-slot dispatch and per-token combine (max, denom) softmax stats,
    streamed over token chunks. x: (b, m, d) raw tokens; phi_n: (d, S)
    pre-normalized. Returns ``((d_mx, d_den) each (b, S), (c_mx, c_den)
    each (b, m))``, as the routing kernel's stats."""
    b, m, _ = x.shape
    s = phi_n.shape[1]
    xn = l2_normalize(x, axis=-1).float()
    phi_n = phi_n.float()
    chunk = min(chunk_tokens or m, m)
    d_mx = torch.full((b, s), -float("inf"), device=x.device)
    d_den = torch.zeros((b, s), device=x.device)
    c_mx_parts, c_den_parts = [], []
    for i in range(0, m, chunk):
        lg = torch.einsum("bmd,ds->bms", xn[:, i:i + chunk], phi_n)
        cm = lg.amax(-1)  # the combine direction is whole per token
        c_mx_parts.append(cm)
        c_den_parts.append(torch.exp(lg - cm[..., None]).sum(-1))
        mx_new = torch.maximum(d_mx, lg.amax(1))  # online, per slot
        d_den = d_den * torch.exp(d_mx - mx_new) + torch.exp(
            lg - mx_new[:, None, :]).sum(1)
        d_mx = mx_new
    return ((d_mx, d_den),
            (torch.cat(c_mx_parts, 1), torch.cat(c_den_parts, 1)))


def routing_health_from_stats(x, phi_n, d_stats, c_stats,
                              chunk_tokens: int = 512):
    """Chunked plain-torch twin of ``kernels.ops.routing_health``:
    ``(disp_entropy (b, S), importance (b, S), comb_entropy (b, m),
    token_contrib (b, m))`` from the saved (max, denom) stats."""
    b, m, _ = x.shape
    s = phi_n.shape[1]
    d_mx, d_den = (t.float() for t in d_stats)
    c_mx, c_den = (t.float() for t in c_stats)
    xn = l2_normalize(x, axis=-1).float()
    phi_n = phi_n.float()
    chunk = min(chunk_tokens or m, m)
    dent = torch.zeros((b, s), device=x.device)
    imp = torch.zeros((b, s), device=x.device)
    cent_parts, contrib_parts = [], []
    log_dden = torch.log(d_den)
    for i in range(0, m, chunk):
        lg = torch.einsum("bmd,ds->bms", xn[:, i:i + chunk], phi_n)
        ln_d = lg - d_mx[:, None, :] - log_dden[:, None]
        d_w = torch.exp(ln_d)
        dent = dent - (d_w * ln_d).sum(1)
        contrib_parts.append(d_w.sum(-1))
        cm, cd = c_mx[:, i:i + chunk], c_den[:, i:i + chunk]
        ln_c = lg - cm[..., None] - torch.log(cd)[..., None]
        c_w = torch.exp(ln_c)
        cent_parts.append(-(c_w * ln_c).sum(-1))
        imp = imp + c_w.sum(1)
    return (dent, imp, torch.cat(cent_parts, 1), torch.cat(contrib_parts, 1))


def routing_stats(x, params, method: str = "dense",
                  chunk_tokens: int = 512) -> Dict[str, torch.Tensor]:
    """x: (b, m, d); params: a Soft-MoE layer's params. ``"dense"`` is the
    (b, m, n p)-materializing oracle; ``"chunked"`` computes the same
    statistics from streamed softmax stats, minus the sort-based
    ``tokens_for_*pct`` curves."""
    if method == "chunked":
        return _routing_stats_chunked(x, params, chunk_tokens)
    if method != "dense":
        raise ValueError(f"unknown routing_stats method {method!r}")
    d_w, c_w = soft_moe_weights(x, params["phi"], params["scale"])
    dent, imp, cent, token_contrib = _dense_routing_health(d_w, c_w)
    importance = imp / torch.clamp(imp.amin(-1, keepdim=True), min=1e-9)
    # cumulative dispatch: each slot's weights sorted descending over tokens
    b, m = d_w.shape[:2]
    cum = torch.cumsum(torch.sort(d_w.reshape(b, m, -1), dim=1,
                                  descending=True).values, dim=1)

    def tokens_to_cover(frac):
        return (cum >= frac).int().argmax(dim=1) + 1  # first index reaching

    return {
        "token_contribution": token_contrib,
        "token_contribution_max": token_contrib.max(),
        "token_contribution_min": token_contrib.min(),
        "expert_importance": importance,
        "expert_importance_spread": importance.amax(-1).mean(),
        "tokens_for_50pct": tokens_to_cover(0.5),
        "tokens_for_90pct": tokens_to_cover(0.9),
        "max_dispatch_weight": d_w.max(),
        "max_combine_weight": c_w.max(),
        "dispatch_entropy": dent.mean(),
        "combine_entropy": cent.mean(),
    }


def _routing_stats_chunked(x, params, chunk_tokens: int):
    from ..kernels import ref

    d = params["phi"].shape[0]
    phi_n = ref.normalized_phi(params["phi"].reshape(d, -1), params["scale"])
    d_stats, c_stats = streaming_softmax_stats(x, phi_n, chunk_tokens)
    dent, imp, cent, contrib = routing_health_from_stats(
        x, phi_n, d_stats, c_stats, chunk_tokens)
    importance = imp / torch.clamp(imp.amin(-1, keepdim=True), min=1e-9)
    return {
        "token_contribution": contrib,
        "token_contribution_max": contrib.max(),
        "token_contribution_min": contrib.min(),
        "expert_importance": importance,
        "expert_importance_spread": importance.amax(-1).mean(),
        # a column's or row's largest softmax weight is exp(mx - mx) / den
        "max_dispatch_weight": (1.0 / d_stats[1]).max(),
        "max_combine_weight": (1.0 / c_stats[1]).max(),
        "dispatch_entropy": dent.mean(),
        "combine_entropy": cent.mean(),
    }


def summarize(stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalars as floats; arrays as ``<name>_mean`` and ``<name>_p90``."""
    out = {}
    for k, v in stats.items():
        arr = torch.as_tensor(v)
        if arr.ndim == 0:
            out[k] = float(arr)
        else:
            arr = arr.double()
            out[f"{k}_mean"] = float(arr.mean())
            # numpy's default percentile: linear between closest ranks
            out[f"{k}_p90"] = float(torch.quantile(arr.flatten(), 0.9))
    return out
