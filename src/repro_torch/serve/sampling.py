"""Batched sampler suite with PER-REQUEST parameters, counterpart of
``repro/serve/sampling.py``.

Greedy / temperature / top-k / top-p are vectorized masking over the
(num_slots, vocab) logits, so a mixed batch is one pass. Randomness is
per request: row i draws Gumbel noise from a ``torch.Generator`` seeded
from ``(seed_i, step_i)``, where step_i counts that request's generated
tokens, so a request reproduces its stream whatever slot or co-batch it
gets. The JAX package keys on ``fold_in(PRNGKey(seed), step)``, which
torch cannot reproduce: the two packages agree token for token under
greedy decoding only.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls.

    temperature <= 0 means greedy (argmax); top_k <= 0 disables the top-k
    filter; top_p >= 1 disables the nucleus filter. Filters compose
    sequentially (HF-style): logits are temperature-scaled, top-k-masked,
    and the nucleus is computed on the renormalized top-k survivors.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


GREEDY = SamplingParams()


def stack_params(params_list) -> dict:
    """Struct-of-arrays view of a list of SamplingParams (host numpy; fed
    straight into `sample_tokens`)."""
    return {
        "temperature": np.array([p.temperature for p in params_list],
                                np.float32),
        "top_k": np.array([p.top_k for p in params_list], np.int32),
        "top_p": np.array([p.top_p for p in params_list], np.float32),
        "seed": np.array([p.seed for p in params_list], np.int32),
    }


_MASK64 = (1 << 64) - 1


def _row_seed(seed: int, step: int) -> int:
    """splitmix64 of (seed, step): one well-mixed generator seed per
    (request seed, token index)."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _topk_mask(scaled, top_k):
    """Keep the top_k largest logits per row; top_k<=0 keeps everything."""
    v = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_k > 0, top_k.clamp(1, v), v)
    thr = torch.gather(sorted_desc, 1, (k_eff - 1).long()[:, None])
    return scaled >= thr  # (B, V)


def _topp_mask(scaled, top_p):
    """Nucleus filter: smallest prefix of descending-prob tokens whose mass
    reaches top_p; the argmax lane always survives and ``top_p >= 1``
    disables the filter exactly (see the JAX module for why both)."""
    probs = torch.softmax(scaled, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sp = torch.gather(probs, 1, order)
    cum_before = torch.cumsum(sp, dim=-1) - sp  # exclusive cumsum
    keep_sorted = cum_before < top_p[:, None]
    keep = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
    rows = torch.arange(scaled.shape[0], device=scaled.device)
    keep[rows, torch.argmax(scaled, dim=-1)] = True
    return keep | (top_p[:, None] >= 1.0)


def _filtered_logits(logits, temperature, top_k, top_p):
    """Temperature-scaled logits with the top-k mask and (renormalized)
    nucleus mask applied sequentially. logits: (B, V) f32; params (B,)
    tensors. Non-finite lanes are coerced to -inf first. Returns (B, V)
    with filtered lanes at -inf."""
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    neg = torch.full_like(scaled, -torch.inf)
    scaled = torch.where(torch.isfinite(scaled), scaled, neg)
    after_k = torch.where(_topk_mask(scaled, top_k), scaled, neg)
    return torch.where(_topp_mask(after_k, top_p), after_k, neg)


def guard_support(masked):
    """Returns ``(guarded, support)``: ``support[b]`` is True iff row b
    kept a finite lane; rows without support become zeros (a defined,
    uniform distribution). Callers treat those rows as poisoned."""
    support = torch.isfinite(masked).any(dim=-1)
    return torch.where(support[:, None], masked,
                       torch.zeros_like(masked)), support


def finite_rows(logits):
    """(B, ...) -> (B,) bool: True iff every logit of the row is finite."""
    return torch.isfinite(logits).flatten(1).all(dim=1)


def sample_tokens(logits, temperature, top_k, top_p, seed, step):
    """logits: (B, V); the per-row params are host arrays (B,). Returns
    (B,) int64 tokens on logits' device. Rows with temperature <= 0 are
    greedy; a sampled row takes the Gumbel-max of its filtered logits
    with noise from a generator seeded by ``_row_seed(seed, step)``."""
    logits = logits.float()
    neg = torch.full_like(logits, -torch.inf)
    toks = torch.argmax(torch.where(torch.isfinite(logits), logits, neg),
                        dim=-1)
    temperature = np.asarray(temperature, np.float32)
    rows = np.flatnonzero(temperature > 0.0)
    if rows.size == 0:
        return toks
    dev = logits.device
    sel = torch.as_tensor(rows, device=dev)

    def col(a, dtype):
        return torch.as_tensor(np.asarray(a)[rows], dtype=dtype, device=dev)

    masked, _ = guard_support(_filtered_logits(
        logits[sel], col(temperature, torch.float32),
        col(top_k, torch.int64), col(top_p, torch.float32)))
    seed, step = np.asarray(seed), np.asarray(step)
    noise = torch.empty_like(masked)
    for i, r in enumerate(rows):
        gen = torch.Generator(device=dev)
        gen.manual_seed(_row_seed(seed[r], step[r]))
        noise[i].uniform_(generator=gen)
    gumbel = -torch.log(-torch.log(noise))
    toks[sel] = torch.argmax(masked + gumbel, dim=-1)
    return toks


def sample_tokens_checked(logits, temperature, top_k, top_p, seed, step):
    """`sample_tokens` fused with the per-row health check: returns
    ``(tokens, ok)`` where ``ok[b]`` is False iff row b's logits carry a
    non-finite value (the engine retires such rows)."""
    return (sample_tokens(logits, temperature, top_k, top_p, seed, step),
            finite_rows(logits))


# ---------------------------------------------------------------------------
# Speculative decoding: vectorized accept
# ---------------------------------------------------------------------------


def spec_accept_tokens(logits, drafts, n_draft, temperature, top_k, top_p,
                       seed, step):
    """Speculative-decoding accept step against a DETERMINISTIC drafter,
    for the whole batch (counterpart of the JAX package's
    ``spec_accept_tokens``).

    logits: (B, K+1, V) verify logits (``logits[:, j]`` is the
    next-token distribution after verify lane j; lane 0 is the pending
    token, lanes 1..K the drafts). drafts: (B, K) and n_draft: (B,) host
    or device integers; the sampling suite as `sample_tokens` takes it.

    Lane j's chain token is what the non-speculative engine emits at
    that position: the argmax for greedy rows, and for sampled rows the
    Gumbel-max draw `sample_tokens` makes at step ``step + j`` (the same
    filtered row and the same generator seed ``_row_seed(seed, step +
    j)``), so the chain is bitwise the plain engine's stream. A draft is
    accepted iff it equals its chain token, and the boundary lane emits
    the chain token itself.

    Returns ``(n_acc, tokens)``: row b accepts its first ``n_acc[b]``
    drafts and emits ``tokens[b, :n_acc[b]+1]``."""
    b, k1, v = logits.shape
    k = k1 - 1
    dev = logits.device

    def lanes(a):
        return np.repeat(np.asarray(a), k1)

    chain = sample_tokens(
        logits.reshape(b * k1, v), lanes(temperature), lanes(top_k),
        lanes(top_p), lanes(seed),
        (np.asarray(step)[:, None] + np.arange(k1)).reshape(-1),
    ).reshape(b, k1)
    drafts = torch.as_tensor(drafts, device=dev).long()
    n_draft = torch.as_tensor(n_draft, device=dev)
    ok = (drafts == chain[:, :k]) & (
        torch.arange(k, device=dev)[None] < n_draft[:, None])
    n_acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    return n_acc, chain


# ---------------------------------------------------------------------------
# Single-shot convenience samplers (the reference's wave engine, examples
# and tests)
# ---------------------------------------------------------------------------


def sample_greedy(gen, logits):
    """logits: (B, S, V) -> (B,) int32, the argmax at the last position.
    ``gen`` (a ``torch.Generator`` or None) is unused: the signature is
    the reference's, whose first argument is a PRNG key."""
    del gen
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def sample_temperature(gen, logits, temperature: float = 1.0):
    """logits: (B, S, V) -> (B,) int32 drawn from softmax(last / T) by the
    Gumbel-max trick, with uniform noise from the ``torch.Generator``
    ``gen`` (on logits' device). T is floored at 1e-6, as in the
    reference, where the draw is the argmax."""
    last = logits[:, -1].float() / max(float(temperature), 1e-6)
    noise = torch.rand(last.shape, generator=gen, device=last.device)
    gumbel = -torch.log(-torch.log(noise.clamp_min(1e-20)))
    return torch.argmax(last + gumbel, dim=-1).to(torch.int32)
