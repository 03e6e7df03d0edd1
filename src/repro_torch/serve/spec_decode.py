"""Speculative decoding over the serving cache pool, counterpart of
``repro/serve/spec_decode.py``.

A cheap DRAFTER proposes up to k tokens a row, one batched (B, k+1)
VERIFY step runs them all through the target model (the chunked-prefill
continuation path), and an ACCEPT step commits a prefix of the draft
plus one boundary token. Acceptance is exact match against the plain
sampler's own chain (greedy: the argmax; sampled: the Gumbel-max draw
with the generator seed ``_row_seed(seed, step)`` that ``sample_tokens``
uses at that step, see ``sampling.spec_accept_tokens``), so the served
stream is token for token the non-speculative engine's on the same
logits at every temperature.

Drafting is SELF-drafting by default: `NgramDrafter` proposes the
continuation of the most recent earlier occurrence of the context's
trailing n-gram (prompt-lookup decoding). The `Drafter` interface is one
method.

Rollback invariants:

* Rejected draft tokens DID write K/V during the verify. Their entries
  are beyond the row's committed frontier, so causal masking hides them,
  and the engine also scrubs them (pos -> -1), so the cache EQUALS never
  having drafted.
* The paged backend un-reserves blocks that only held rejected tokens
  (`rollback_burst`): tables and refcounts after a rollback match the
  non-speculative path exactly.
* Per-request sampling steps advance by the tokens a burst committed,
  and the token at step s is a pure function of (context, seed, s), so a
  preempted request replays the same stream on its retry.

Support, as in the reference: the paged backend (every position owns a
unique (block, offset)); the contiguous backend when its rings never
wrap (a rejected write on a wrapped ring evicts a live entry). SSM and
hybrid archs are refused: recurrent state advanced by a rejected token
cannot be rewound. Sparse-MoE archs route each row's tokens
independently and droplessly when serving, so the verify equals k+1
decode steps up to rounding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, Sequence

import numpy as np
import torch

from .sampling import finite_rows, spec_accept_tokens
from .tracing import SPAN_DECODE_TICK, SPAN_SPEC_BURST


class Drafter(Protocol):
    """Anything that proposes draft tokens from a row's committed context
    (prompt + generated so far, ending with the pending token). MUST be
    deterministic in the context: preemption replay relies on drafts
    being a pure function of the tokens."""

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        """Up to `k` draft tokens continuing `context` ([] = no draft —
        the row falls back to a plain one-token step this tick)."""
        ...


class NgramDrafter:
    """Prompt-lookup self-drafting: find the most recent earlier
    occurrence of the context's trailing n-gram (longest n first) and
    propose the tokens that followed it. O(n_gram * len) per call on the
    host — contexts are at most max_len tokens, and the scan is trivially
    cheap next to a model call."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        assert 1 <= min_n <= max_n
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        ctx = list(context)
        for n in range(min(self.max_n, len(ctx) - 1), self.min_n - 1, -1):
            tail = ctx[-n:]
            # scan right-to-left: most recent match wins (recency beats
            # frequency for continuation prediction)
            for i in range(len(ctx) - n - 1, -1, -1):
                if ctx[i: i + n] == tail:
                    cont = ctx[i + n: i + n + k]
                    if cont:
                        return cont
        return []


@dataclass
class SpecConfig:
    """Engine-facing speculative-decoding knobs.

    ``k``: draft tokens per verify step (the verify step has k+1
    lanes). ``drafter``: any `Drafter`; None = NgramDrafter with
    the given n-gram bounds.

    Graceful degradation: a misbehaving drafter must never take the
    engine down — it can only cost speed. ``disable_after_rejects``
    consecutive fully-rejected bursts on one row turn drafting OFF for
    that row (it keeps decoding correctly at one committed token per
    verify, lane 0 only); ``max_drafter_errors`` drafter exceptions on a
    row do the same. 0 disables either trigger. Per-row state resets
    when the slot turns over to a new request."""

    k: int = 4
    ngram_max: int = 3
    ngram_min: int = 1
    drafter: Optional[Drafter] = None
    disable_after_rejects: int = 8
    max_drafter_errors: int = 2


class SpecDecoder:
    """Drives one ServeEngine's decode phase speculatively.

    Owns the per-slot pending token (sampled, recorded, streamed, but
    its K/V not yet written; it rides verify lane 0 next tick), the
    drafter, and the acceptance stats. The engine delegates `_do_decode`
    here when speculation is enabled; admission, prefill, preemption and
    retirement stay engine-owned.
    """

    def __init__(self, engine, cfg: SpecConfig):
        mcfg = engine.cfg
        if cfg.k < 1:
            raise ValueError("SpecConfig.k must be >= 1")
        if mcfg.has_ssm():
            raise ValueError(
                "speculative decoding needs a rollbackable cache; "
                "recurrent SSM state advanced by a rejected draft cannot "
                "be rewound"
            )
        if mcfg.attention is None:
            raise ValueError("speculative decoding needs an attention LM")
        from .cache_pool import ContiguousBackend
        a = mcfg.attention
        if (isinstance(engine.backend, ContiguousBackend)
                and a.sliding_window is not None
                and a.sliding_window < engine.max_len):
            raise ValueError(
                "speculative decoding on the contiguous backend needs "
                "non-wrapping rings (sliding_window < max_len evicts live "
                "entries on a rejected write); use backend='paged', which "
                "stores every position and masks the window instead"
            )
        if cfg.k + 1 > engine.backend.max_chunk:
            raise ValueError(
                f"spec k={cfg.k} exceeds the backend burst limit "
                f"({engine.backend.max_chunk - 1})"
            )
        self.eng = engine
        self.k = cfg.k
        self.cfg_spec = cfg
        self.drafter = cfg.drafter or NgramDrafter(cfg.ngram_max,
                                                   cfg.ngram_min)
        # pending[slot] = sampled-but-not-fed token id (-1 = none); it is
        # already in req.out/streamed — only its KV write is outstanding.
        self._pending = np.full((engine.batch,), -1, np.int64)
        # Per-row degradation state: consecutive fully-rejected bursts,
        # drafter exceptions, and the resulting draft kill-switch. All
        # reset when the slot turns over (drop_slot).
        self._reject_streak = np.zeros((engine.batch,), np.int32)
        self._drafter_errs = np.zeros((engine.batch,), np.int32)
        self._draft_disabled = np.zeros((engine.batch,), bool)
        # stats (``ServeEngine.spec_stats``)
        self.verify_calls = 0
        self.drafted = 0
        self.accepted = 0
        self.tokens_emitted = 0
        self.rows_disabled = 0  # rows whose drafting was auto-disabled
        self.drafter_errors = 0  # drafter exceptions swallowed

    # -- stats -------------------------------------------------------------

    @property
    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the target model accepted."""
        return self.accepted / max(self.drafted, 1)

    def calls_per_token(self) -> float:
        """BATCHED verify calls per emitted token across all rows (one
        verify advances every live row). For the per-row
        calls-per-token metric the spec-decoding literature quotes,
        normalize by the live batch size."""
        return self.verify_calls / max(self.tokens_emitted, 1)

    def drop_slot(self, slot: int):
        """Forget a slot's pending token and degradation state
        (preemption/retirement — the next occupant starts clean)."""
        self._pending[slot] = -1
        self._reject_streak[slot] = 0
        self._drafter_errs[slot] = 0
        self._draft_disabled[slot] = False

    def _disable_row(self, slot: int):
        if not self._draft_disabled[slot]:
            self._draft_disabled[slot] = True
            self.rows_disabled += 1

    def _propose(self, slot: int, entry, n: int) -> List[int]:
        """Draft for one row, tolerating a hostile drafter: exceptions
        are swallowed (and counted toward the row's kill-switch) and
        out-of-vocab token ids are truncated at — a garbage id would
        index the embedding out of range. A disabled row drafts
        nothing and decodes correctly at one token per verify."""
        if self._draft_disabled[slot]:
            return []
        try:
            drafts = list(self.drafter.propose(
                list(entry.req.prompt) + list(entry.req.out), n
            ))[:n]
        except Exception:
            self.drafter_errors += 1
            self._drafter_errs[slot] += 1
            ma = self.cfg_spec.max_drafter_errors
            if ma and self._drafter_errs[slot] >= ma:
                self._disable_row(slot)
            return []
        vocab = self.eng.cfg.vocab_size
        for i, t in enumerate(drafts):
            if not (0 <= int(t) < vocab):
                return drafts[:i]
        return drafts

    def reset_stats(self):
        """Zero the speculation counters (after a warm-up, so it does not
        enter the measured acceptance rate)."""
        self.verify_calls = 0
        self.drafted = 0
        self.accepted = 0
        self.tokens_emitted = 0
        self.rows_disabled = 0
        self.drafter_errors = 0

    # -- the tick ----------------------------------------------------------

    def decode_tick(self) -> int:
        """Speculative replacement for ServeEngine._do_decode: phase 1
        samples first tokens for rows fresh out of prefill (from the
        prefill logits, exactly like the baseline engine — no model
        call); phase 2 drafts, verifies in one (B, k+1) model call,
        accepts by exact match, commits with EOS/budget/ceiling
        truncation, and rolls back rejected state. Returns tokens
        emitted this tick."""
        eng = self.eng
        sched = eng.sched
        entries = sched.decode_entries()
        if not entries:
            return 0
        emitted_total = 0

        fresh = [e for e in entries if self._pending[e.slot] < 0]
        if fresh:
            toks, ok = eng._sample(
                eng._logits, eng._temp, eng._top_k, eng._top_p,
                eng._seed, eng._step,
            )
            toks, ok = toks.cpu().numpy(), ok.cpu().numpy()
            for e in fresh:
                if not ok[e.slot]:
                    eng._abort_entry(e, "error")
                    eng.nonfinite_retired += 1
                    continue
                tok = int(toks[e.slot])
                eng._step[e.slot] += 1
                emitted_total += 1
                self.tokens_emitted += 1
                finished = sched.record_token(e, tok)
                if eng.tracer is not None:
                    eng.tracer.span(e.req, SPAN_DECODE_TICK, token=tok)
                if finished:
                    eng._retire_entry(e)
                else:
                    self._pending[e.slot] = tok

        live = [e for e in entries if self._pending[e.slot] >= 0]
        if not live:
            return emitted_total

        k = self.k
        in_toks = np.full((eng.batch, k + 1), eng.pad_id, np.int64)
        in_pos = np.full((eng.batch, k + 1), -1, np.int32)
        n_draft = np.zeros((eng.batch,), np.int32)
        plans = {}  # slot -> (entry, lane-0 write position)
        for e in list(live):
            slot = e.slot
            # cap drafts at the remaining budget (tokens past it would be
            # truncated anyway) and the cache ceiling (a position >=
            # max_len has no slot to write — and on a ring it would wrap
            # onto live entries)
            budget_left = e.req.max_new_tokens - e.n_generated
            k_cap = max(0, min(k, budget_left - 1, eng.max_len - 1 - e.pos))
            cover = eng.backend.reserve_burst(slot, e.pos, k_cap + 1)
            if cover <= 0:
                eng._preempt(e)  # drops this slot's pending token too
                continue
            drafts = []
            if cover > 1:
                drafts = self._propose(slot, e, cover - 1)
            m = len(drafts)
            in_toks[slot, 0] = self._pending[slot]
            if m:
                in_toks[slot, 1: 1 + m] = drafts
            in_pos[slot, : 1 + m] = e.pos + np.arange(1 + m)
            n_draft[slot] = m
            self.drafted += m
            plans[slot] = (e, e.pos)
        if not plans:
            return emitted_total

        dev = eng.device
        logits = eng._call_model(
            [e for e, _ in plans.values()], eng.backend.verify,
            torch.as_tensor(in_toks, device=dev),
            torch.as_tensor(in_pos, device=dev),
        )
        eng.decode_steps += 1
        self.verify_calls += 1
        n_acc, out_toks = spec_accept_tokens(
            logits, in_toks[:, 1:], n_draft,
            eng._temp, eng._top_k, eng._top_p, eng._seed, eng._step,
        )
        n_acc = n_acc.cpu().numpy()
        out_toks = out_toks.cpu().numpy()
        row_ok = finite_rows(logits).cpu().numpy()

        # Rejected-lane scrub: positions the verify wrote that acceptance
        # disowned (lanes n_acc+1 .. n_draft), one (B, k+1) batch a tick.
        inval = np.full((eng.batch, k + 1), -1, np.int32)
        rollbacks = []
        for slot, (e, base) in plans.items():
            if not row_ok[slot]:
                # Poisoned verify logits: nothing this row produced can
                # be trusted — retire it (releasing its burst blocks
                # wholesale) rather than committing NaN-derived tokens.
                eng._abort_entry(e, "error")
                eng.nonfinite_retired += 1
                continue
            na = int(n_acc[slot])
            m = int(n_draft[slot])
            if m and na == 0:
                self._reject_streak[slot] += 1
                lim = self.cfg_spec.disable_after_rejects
                if lim and self._reject_streak[slot] >= lim:
                    self._disable_row(slot)
            elif na:
                self._reject_streak[slot] = 0
            burst = [int(t) for t in out_toks[slot, : na + 1]]
            committed, finished = sched.record_tokens(e, burst)
            eng._step[slot] += committed
            emitted_total += committed
            self.tokens_emitted += committed
            self.accepted += na
            if eng.tracer is not None:
                eng.tracer.span(e.req, SPAN_SPEC_BURST, drafted=m,
                                accepted=na, committed=committed)
            if finished:
                eng._retire_entry(e)  # drops the pending token too
            else:
                # committed == len(burst) here (no truncation), so the
                # last burst token is the new pending; e.pos is now its
                # write position.
                self._pending[slot] = burst[-1]
                rej = np.arange(na + 1, int(n_draft[slot]) + 1)
                if rej.size:
                    inval[slot, rej] = base + rej
                rollbacks.append((slot, e.pos))
        eng.backend.invalidate_positions(torch.as_tensor(inval, device=dev))
        for slot, next_pos in rollbacks:
            eng.backend.rollback_burst(slot, next_pos)
        return emitted_total
