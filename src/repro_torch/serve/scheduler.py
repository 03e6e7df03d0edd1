"""Continuous-batching scheduler: admission queue + per-slot state machine.

A copy of the JAX package's ``serve/scheduler.py``. Pure host-side
bookkeeping — no torch in this module — so the policy is unit testable
without a model. The engine (engine.py) owns the device work and
drives one `Scheduler` through ticks:

    FREE --admit/bind--> PREFILL --last chunk--> DECODE --EOS/len--> FREE

* Admission is FIFO. A request is bound to a cache-pool slot the moment one
  is free; its prompt is then fed in fixed-size chunks (one chunk per engine
  tick, interleaved with decode steps so running requests keep streaming
  while a long prompt loads).
* Chunks are RIGHT-ALIGNED: the first chunk is left-padded with position -1
  tokens (exact no-ops at every layer), so every chunk is shape (1, C), the
  last real token always sits at index C-1, and chunk count is the only
  per-request variable — shapes never change, nothing recompiles.
* Retirement is immediate: the tick a row samples EOS (or hits its token
  budget / the cache ceiling) it is released, and the next queued request
  can be admitted into that slot on the same tick's admission pass.
* The queue is BOUNDED (``max_queue``): `submit` raises `QueueFull`
  instead of buffering without limit — the reject path load shedding
  (serve/server.py) is built on. Preemption requeues bypass the bound
  (admitted work is never lost to it).
* Abnormal termination is first-class: `finish(entry, reason)` retires a
  live row with finish_reason "cancelled" / "deadline" / "error" and
  `drop_queued` removes a request that never got memory — both leave the
  state machine exactly as a normal retirement does (the caller releases
  backend resources, as with any retirement).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .sampling import GREEDY, SamplingParams


class QueueFull(RuntimeError):
    """submit() on a scheduler whose bounded queue is at capacity."""


@dataclass
class Request:
    """One generation request. `out` accumulates generated token ids;
    `on_token` (if set) streams each token as it is sampled. Timing fields
    are wall-clock (perf_counter) and filled by the engine for latency
    accounting: t_submit at submit, t_first_token at the first sampled
    token, t_done at retirement."""

    prompt: List[int]
    max_new_tokens: int = 16
    sampling: SamplingParams = field(default_factory=lambda: GREEDY)
    out: List[int] = field(default_factory=list)
    done: bool = False
    # Why generation stopped: "eos" (sampled the stop token), "length"
    # (max_new_tokens reached), or "cache_ceiling" (prompt+generation hit
    # the engine's max_len — a truncation, NOT a normal completion; the
    # bench and examples report it separately). Abnormal terminals:
    # "cancelled" (client cancellation), "deadline" (TTFT/total deadline
    # expired), "shed" (admission control rejected it), "error" (the row
    # produced non-finite logits and was retired to protect the batch).
    # None while running.
    finish_reason: Optional[str] = None
    # Deadlines, in seconds RELATIVE to t_submit (None = none). The
    # engine's tick loop expires them: ttft_deadline_s while no token has
    # been delivered, deadline_s against total residency — queued or
    # live, the request finishes with finish_reason="deadline" and every
    # resource it held is released that same tick.
    ttft_deadline_s: Optional[float] = None
    deadline_s: Optional[float] = None
    on_token: Optional[Callable[["Request", int], None]] = None
    t_submit: float = 0.0
    # First bind to a slot (queue time = t_admitted - t_submit); a
    # preemption retry keeps the ORIGINAL admission time.
    t_admitted: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    # Set after a preemption: the retry must not pin prefix-cache blocks,
    # so eviction can always reclaim enough memory to finish it.
    no_prefix_cache: bool = False
    # Tokens already streamed via on_token before a preemption; the retry
    # replays the identical seeded stream, so callbacks stay suppressed
    # until generation passes this watermark (no duplicate streaming).
    stream_resume: int = 0
    # Trace timeline: (perf_counter, span_kind, attrs) events appended by
    # serve/tracing.py when the engine runs with trace=True; None when
    # tracing is off (the untraced cost is one `is None` check).
    spans: Optional[List[tuple]] = None


# Slot states
FREE = "free"
PREFILL = "prefill"
DECODE = "decode"


@dataclass
class SlotEntry:
    """Scheduler-side state of one occupied cache-pool slot.

    ``start_pos`` is the first prompt position prefill actually runs —
    positions [0, start_pos) were served out of the paged backend's
    prefix cache and already sit in this row's block table. Always 0 on
    the contiguous backend."""

    slot: int
    req: Request
    chunk: int  # prefill chunk size the prompt was split into
    n_chunks: int
    left_pad: int  # invalid tokens prepended to the first chunk
    start_pos: int = 0
    next_chunk: int = 0
    pos: int = 0  # absolute position the next input token writes
    n_generated: int = 0
    state: str = PREFILL

    def prefill_done(self) -> bool:
        return self.next_chunk >= self.n_chunks

    def take_chunk(self):
        """Token ids + positions of the next prompt chunk (lists of length
        `chunk`; positions are -1 on the left pad)."""
        assert self.state == PREFILL and not self.prefill_done()
        j = self.next_chunk
        p = self.req.prompt
        toks, poss = [], []
        for i in range(j * self.chunk, (j + 1) * self.chunk):
            k = self.start_pos + (i - self.left_pad)  # prompt index
            if k < self.start_pos:
                toks.append(0)
                poss.append(-1)
            else:
                toks.append(int(p[k]))
                poss.append(k)
        self.next_chunk += 1
        if self.prefill_done():
            self.state = DECODE
            self.pos = len(p)
        return toks, poss


class Scheduler:
    def __init__(self, prefill_chunk: int, max_len: int,
                 eos_id: Optional[int] = None,
                 max_queue: Optional[int] = None):
        assert prefill_chunk >= 1
        assert max_queue is None or max_queue >= 1
        self.prefill_chunk = prefill_chunk
        self.max_len = max_len
        self.eos_id = eos_id
        self.max_queue = max_queue
        self.queue: deque = deque()
        self.live: Dict[int, SlotEntry] = {}

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request):
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise QueueFull(
                f"admission queue at capacity ({self.max_queue})"
            )
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def has_queued(self) -> bool:
        return bool(self.queue)

    def peek(self) -> Request:
        """Oldest queued request (admission decisions inspect the prompt
        before committing memory)."""
        return self.queue[0]

    def pending(self) -> bool:
        return bool(self.queue or self.live)

    def bind(self, slot: int, start_pos: int = 0) -> SlotEntry:
        """Admit the oldest queued request into `slot` (caller acquired it
        from the cache backend, i.e. the row/table is ready). With
        ``start_pos`` > 0, prefill covers only prompt[start_pos:] — the
        prefix-cache hit path."""
        req = self.queue.popleft()
        if req.t_admitted == 0.0:
            req.t_admitted = time.perf_counter()
        p = len(req.prompt)
        assert p >= 1, "empty prompt"
        assert 0 <= start_pos < p, "must re-run at least the last token"
        c = self.prefill_chunk
        tail = p - start_pos
        n_chunks = -(-tail // c)
        entry = SlotEntry(
            slot=slot, req=req, chunk=c, n_chunks=n_chunks,
            left_pad=n_chunks * c - tail, start_pos=start_pos,
        )
        self.live[slot] = entry
        return entry

    def requeue(self, entry: SlotEntry):
        """Preemption: put a live request back at the FRONT of the queue
        with a full restart (its memory was reclaimed — generated tokens
        are discarded and will be regenerated; per-request seeded sampling
        replays the identical stream)."""
        del self.live[entry.slot]
        entry.state = FREE
        req = entry.req
        req.stream_resume = max(req.stream_resume, len(req.out))
        req.out = []
        req.done = False
        req.finish_reason = None
        self.queue.appendleft(req)

    # -- tick queries ------------------------------------------------------

    def next_prefill(self) -> Optional[SlotEntry]:
        """Oldest slot still prefilling (FIFO over bind order — dict
        preserves insertion order)."""
        for e in self.live.values():
            if e.state == PREFILL:
                return e
        return None

    def decode_entries(self) -> List[SlotEntry]:
        return [e for e in self.live.values() if e.state == DECODE]

    # -- abnormal termination ----------------------------------------------

    def finish(self, entry: SlotEntry, reason: str):
        """Retire a LIVE row without a final token: cancellation, deadline
        expiry, or a poisoned-row error. Leaves the state machine exactly
        as `record_token` retirement does — the caller must release the
        slot's backend resources, same as any retirement."""
        req = entry.req
        req.done = True
        req.finish_reason = reason
        req.t_done = time.perf_counter()
        del self.live[entry.slot]
        entry.state = FREE

    def drop_queued(self, req: Request, reason: str) -> bool:
        """Finish a request that is still QUEUED (never bound to memory):
        deadline expiry before admission, or an explicit cancellation.
        Returns False if `req` is not in the queue."""
        try:
            self.queue.remove(req)
        except ValueError:
            return False
        req.done = True
        req.finish_reason = reason
        req.t_done = time.perf_counter()
        return True

    def entry_for(self, req: Request) -> Optional[SlotEntry]:
        """The live slot entry serving `req`, if any."""
        for e in self.live.values():
            if e.req is req:
                return e
        return None

    # -- retirement --------------------------------------------------------

    def record_token(self, entry: SlotEntry, token: int) -> bool:
        """Account one sampled token for a DECODE row; returns True if the
        request retired (caller must release the slot to the pool)."""
        req = entry.req
        now = time.perf_counter()
        # t_first_token == 0.0 means never delivered: a preemption retry
        # keeps the ORIGINAL first-token time (those tokens reached the
        # caller; the replay is internal), so TTFT stays honest.
        if not req.out and req.t_first_token == 0.0:
            req.t_first_token = now
        req.out.append(token)
        entry.n_generated += 1
        if req.on_token is not None and len(req.out) > req.stream_resume:
            req.on_token(req, token)
        hit_eos = self.eos_id is not None and token == self.eos_id
        out_of_budget = entry.n_generated >= req.max_new_tokens
        cache_full = entry.pos >= self.max_len
        if hit_eos or out_of_budget or cache_full:
            # EOS dominates (a natural stop even at the budget edge);
            # cache_ceiling only when nothing else explains the stop, so
            # a truncation is never mislabeled as a completion.
            req.finish_reason = (
                "eos" if hit_eos else
                "length" if out_of_budget else "cache_ceiling"
            )
            req.done = True
            req.t_done = now
            del self.live[entry.slot]
            entry.state = FREE
            return True
        return False

    def record_tokens(self, entry: SlotEntry, tokens) -> "tuple[int, bool]":
        """Account a speculative burst for a DECODE row: commit `tokens`
        in order with exactly `record_token`'s EOS/budget/ceiling
        accounting, TRUNCATING at the first stop — tokens an accepted
        draft carried past an EOS are discarded, never appended to
        ``req.out`` and never streamed. ``entry.pos`` must be the write
        position of the row's pending token (the burst's verify lane 0);
        it advances to each committed token's write position before its
        accounting, mirroring the one-token path where `record_token`
        runs with ``entry.pos`` at the recorded token's write position.
        Returns ``(n_committed, finished)``."""
        n = 0
        for tok in tokens:
            entry.pos += 1
            n += 1
            if self.record_token(entry, int(tok)):
                return n, True
        return n, False
