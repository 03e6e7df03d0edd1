"""Per-request trace timelines and the engine's tick flight recorder,
counterpart of ``repro/serve/tracing.py`` (host-only Python).

Span events and tick records are plain Python appended around the
device programs, never inside them, so tracing cannot change a served
token (bitwise equal outputs with tracing on and off, greedy and
sampled, on both backends).

Three surfaces:

* ``Tracer``: each ``Request`` accumulates typed span events ``(t, kind,
  attrs)`` with monotonic ``perf_counter`` timestamps: submitted,
  admitted(slot, cached), prefill_chunk(i), decode_tick,
  spec_burst(drafted, accepted, committed), preempted/requeued,
  kernel_fallback (the reference's; the port's engine has no fallback
  and never emits it), retired(reason). ``timeline(req)`` returns the
  structured dict, ``render_timeline(reqs)`` draws a text Gantt, and
  ``validate_timeline(req)`` is the consistency contract the chaos
  harness asserts for every terminal request: monotonic timestamps,
  exactly one submitted/retired pair, the retired reason equal to
  ``finish_reason``, shed requests never admitted, and committed-token
  spans after the last requeue summing to ``len(req.out)``.
* ``FlightRecorder`` (from ``repro_torch/tracing.py``, re-exported): a
  bounded ring of per-tick engine records (queue and batch occupancy,
  blocks free and live, tokens emitted, per-program host wall time).
  ``dump(reason, path)`` freezes the ring for a post-mortem; the
  server's watchdog and pump-crash paths call it.
* ``ProgramTimer`` (from ``repro_torch/tracing.py``, re-exported): a
  transparent wrapper around one program that accumulates host-side
  call counts and wall time, each call a span of its name; other
  attributes pass through to the wrapped callable.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

from ..tracing import FlightRecorder, ProgramTimer  # noqa: F401

# -- span kinds --------------------------------------------------------------

SPAN_SUBMITTED = "submitted"
SPAN_ADMITTED = "admitted"
SPAN_PREFILL_CHUNK = "prefill_chunk"
SPAN_DECODE_TICK = "decode_tick"
SPAN_SPEC_BURST = "spec_burst"
SPAN_PREEMPTED = "preempted"
SPAN_REQUEUED = "requeued"
SPAN_KERNEL_FALLBACK = "kernel_fallback"
SPAN_RETIRED = "retired"

SPAN_KINDS = (
    SPAN_SUBMITTED, SPAN_ADMITTED, SPAN_PREFILL_CHUNK, SPAN_DECODE_TICK,
    SPAN_SPEC_BURST, SPAN_PREEMPTED, SPAN_REQUEUED, SPAN_KERNEL_FALLBACK,
    SPAN_RETIRED,
)

# Terminal reasons that imply the request actually ran (was admitted and
# prefetched at least one chunk). Abnormal reasons can land at any stage.
_RAN_TO_COMPLETION = {"eos", "length", "cache_ceiling"}


class Tracer:
    """Appends span events to ``Request.spans`` (created lazily at
    ``start``; requests submitted while tracing is off keep spans=None
    and cost one ``is None`` check per would-be span)."""

    def __init__(self):
        self.started = 0
        self.spans_recorded = 0

    def start(self, req):
        """First sight of a request (engine submit). Idempotent — a
        retry after a shed re-enters submit but keeps one timeline."""
        if req.spans is None:
            req.spans = []
            self.started += 1
            self.span(req, SPAN_SUBMITTED)

    def span(self, req, kind: str, **attrs):
        if req.spans is not None:
            req.spans.append((time.perf_counter(), kind, attrs))
            self.spans_recorded += 1

    def shed(self, req):
        """Terminal span for a request admission control rejected —
        it never reached the engine's submit, so open its timeline
        here."""
        self.start(req)
        self.span(req, SPAN_RETIRED, reason="shed")


def timeline(req) -> dict:
    """Structured view of one request's spans: timestamps relative to
    submission, plus the derived queue/ttft/total durations."""
    spans = req.spans or []
    t0 = spans[0][0] if spans else 0.0
    out = {
        "finish_reason": req.finish_reason,
        "n_spans": len(spans),
        "n_tokens": len(req.out),
        "spans": [
            {"t": t - t0, "kind": kind, **attrs}
            for t, kind, attrs in spans
        ],
    }
    by_kind = {}
    for t, kind, _ in spans:
        by_kind.setdefault(kind, t)
    if SPAN_ADMITTED in by_kind:
        out["queue_s"] = by_kind[SPAN_ADMITTED] - t0
    if req.t_first_token:
        out["ttft_s"] = req.t_first_token - req.t_submit
    if spans:
        out["total_s"] = spans[-1][0] - t0
    return out


def validate_timeline(req) -> None:
    """Assert one terminal request's span sequence is consistent with
    its finish_reason (the chaos harness runs this over every request).
    Raises AssertionError with context on any violation."""
    assert req.done, "validate_timeline on a non-terminal request"
    spans = req.spans
    assert spans, "terminal request carries no spans"
    ts = [t for t, _, _ in spans]
    assert all(b >= a for a, b in zip(ts, ts[1:])), (
        "non-monotonic span timestamps"
    )
    kinds = [k for _, k, _ in spans]
    unknown = [k for k in kinds if k not in SPAN_KINDS]
    assert not unknown, f"unknown span kinds {unknown}"
    assert kinds[0] == SPAN_SUBMITTED, f"first span {kinds[0]!r}"
    assert kinds.count(SPAN_SUBMITTED) == 1, "duplicate submitted span"
    assert kinds[-1] == SPAN_RETIRED, (
        f"terminal request missing retired span (last: {kinds[-1]!r})"
    )
    assert kinds.count(SPAN_RETIRED) == 1, "duplicate retired span"
    reason = spans[-1][2].get("reason")
    assert reason == req.finish_reason, (
        f"retired span reason {reason!r} != finish_reason "
        f"{req.finish_reason!r}"
    )
    assert kinds.count(SPAN_PREEMPTED) == kinds.count(SPAN_REQUEUED), (
        "unpaired preempted/requeued spans"
    )
    if req.finish_reason == "shed":
        assert SPAN_ADMITTED not in kinds, "shed request was admitted"
        return
    if req.finish_reason in _RAN_TO_COMPLETION:
        assert SPAN_ADMITTED in kinds, "completed without admission span"
        assert SPAN_PREFILL_CHUNK in kinds, (
            "completed without any prefill chunk"
        )
    # Token accounting: everything before the last requeue was discarded
    # (req.out reset); after it, one decode_tick span per committed
    # token plus spec bursts' committed counts must equal len(req.out).
    start = 0
    for i, k in enumerate(kinds):
        if k == SPAN_REQUEUED:
            start = i + 1
    committed = 0
    for _, kind, attrs in spans[start:]:
        if kind == SPAN_DECODE_TICK:
            committed += 1
        elif kind == SPAN_SPEC_BURST:
            committed += int(attrs.get("committed", 0))
    assert committed == len(req.out), (
        f"span token count {committed} != emitted tokens {len(req.out)} "
        f"(finish_reason={req.finish_reason!r})"
    )


def render_timeline(reqs: Sequence, width: int = 64) -> str:
    """Text Gantt over a set of traced requests: one row per request,
    Q = queued, P = prefilling, D = decoding, with markers x (preempted),
    ! (kernel fallback) and the finish_reason + token count per row."""
    traced = [r for r in reqs if r.spans]
    if not traced:
        return "(no traced requests)"
    t0 = min(r.spans[0][0] for r in traced)
    t1 = max(r.spans[-1][0] for r in traced)
    span_s = max(t1 - t0, 1e-9)

    def col(t: float) -> int:
        return min(width - 1, int((t - t0) / span_s * width))

    lines = [
        f"timeline: {span_s * 1e3:.1f} ms total, {len(traced)} requests "
        f"(Q queued, P prefill, D decode, x preempt, ! kernel-fallback)"
    ]
    for i, r in enumerate(traced):
        row = [" "] * width
        # phase boundaries: submitted -> admitted -> first decode -> end
        marks: Dict[str, List[float]] = {}
        for t, kind, _ in r.spans:
            marks.setdefault(kind, []).append(t)
        t_sub = marks[SPAN_SUBMITTED][0]
        t_end = r.spans[-1][0]
        admits = marks.get(SPAN_ADMITTED, [])
        decodes = (marks.get(SPAN_DECODE_TICK, [])
                   + marks.get(SPAN_SPEC_BURST, []))
        t_adm = min(admits) if admits else t_end
        t_dec = min(decodes) if decodes else t_end
        for c in range(col(t_sub), col(t_end) + 1):
            if c < col(t_adm):
                row[c] = "Q"
            elif c < col(t_dec):
                row[c] = "P"
            else:
                row[c] = "D"
        for t in marks.get(SPAN_PREEMPTED, []):
            row[col(t)] = "x"
        for t in marks.get(SPAN_KERNEL_FALLBACK, []):
            row[col(t)] = "!"
        reason = r.finish_reason or "?"
        lines.append(
            f"req {i:>3} |{''.join(row)}| {reason:<13} "
            f"{len(r.out):>3} tok"
        )
    return "\n".join(lines)
