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
* ``FlightRecorder``: a bounded ring of per-tick engine records (queue
  and batch occupancy, blocks free and live, tokens emitted, per-program
  host wall time). ``dump(reason, path)`` freezes the ring for a
  post-mortem; the server's watchdog and pump-crash paths call it.
* ``ProgramTimer``: a transparent wrapper around one program that
  accumulates host-side call counts and wall time; other attributes
  pass through to the wrapped callable.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

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


# -- flight recorder ---------------------------------------------------------


class FlightRecorder:
    """Bounded ring of per-tick engine records for post-mortems.

    The engine appends one dict per tick (``ServeEngine.step`` has the
    schema, the reference's key set); ``dump`` freezes the
    current ring with a reason tag, optionally writing JSON to a path.
    ``ticks`` counts every record ever seen (the ring holds the last
    ``capacity``)."""

    def __init__(self, capacity: int = 256):
        assert capacity >= 1
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self.ticks = 0
        self.dumps = 0
        self.last_dump: Optional[dict] = None
        self.last_dump_path: Optional[str] = None

    def record(self, rec: dict):
        self.ticks += 1
        self._ring.append(rec)

    def records(self) -> List[dict]:
        return list(self._ring)

    def dump(self, reason: str, path: Optional[str] = None) -> dict:
        out = {
            "reason": reason,
            "ticks_seen": self.ticks,
            "capacity": self.capacity,
            "records": self.records(),
        }
        self.dumps += 1
        self.last_dump = out
        if path is not None:
            with open(path, "w") as f:
                json.dump(out, f, indent=1, default=str)
            self.last_dump_path = path
        return out

    def render(self, last: int = 12, records=None) -> str:
        """Compact text table of the most recent records — of the live
        ring, or of an explicit record list (e.g. a frozen
        ``dump["records"]``)."""
        recs = (self.records() if records is None else list(records))[-last:]
        if not recs:
            return "(flight recorder empty)"
        lines = ["tick  live queued emit adm  programs"]
        for r in recs:
            progs = ",".join(
                f"{k}:{v['calls']}" for k, v in
                sorted(r.get("programs", {}).items()) if v["calls"]
            ) or "-"
            lines.append(
                f"{r.get('tick', 0):>5} {r.get('live', 0):>4}"
                f" {r.get('queued', 0):>6} {r.get('emitted', 0):>4}"
                f" {r.get('admitted', 0):>3}  {progs}"
            )
        return "\n".join(lines)


# -- per-program host timing -------------------------------------------------


class ProgramTimer:
    """Wrap one program with host-side wall-time accounting.

    ``calls``/``total_s`` accumulate for the wrapper's lifetime;
    ``take_tick()`` drains the per-tick delta the flight recorder
    stores. Unknown attributes pass through to the wrapped callable.

    On CUDA the time is the host's: the program's launches plus any wait
    inside it, not its device time. No ``torch.cuda.synchronize()`` is
    added, since that would change the serving timing being reported;
    the sampler's copy of its tokens to the host already waits for the
    device once a tick, so the sampler's time carries that wait."""

    def __init__(self, name: str, fn):
        self.name = name
        self.fn = fn
        self.calls = 0
        self.total_s = 0.0
        self._tick_calls = 0
        self._tick_s = 0.0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        self.calls += 1
        self.total_s += dt
        self._tick_calls += 1
        self._tick_s += dt
        return out

    def take_tick(self) -> dict:
        out = {"calls": self._tick_calls, "s": round(self._tick_s, 6)}
        self._tick_calls = 0
        self._tick_s = 0.0
        return out

    def reset(self):
        """Zero the lifetime accumulators (after a warm-up request, so
        ``program_efficiency()`` attributes only steady-state calls)."""
        self.calls = 0
        self.total_s = 0.0
        self._tick_calls = 0
        self._tick_s = 0.0

    def __getattr__(self, name):
        if name == "fn":  # not yet set (mid-__init__): avoid recursion
            raise AttributeError(name)
        return getattr(self.fn, name)
