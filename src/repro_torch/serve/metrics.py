"""Per-request serving metrics and the stuck-step watchdog, counterpart
of ``repro/serve/metrics.py`` (host-only Python).

``ServeMetrics`` is a small counter/series/gauge surface shared by the
async front end (``serve/server.py``) and the fault harness
(``serve/faults.py``). Counters are monotonic ints; series are
``Histogram``s: Prometheus-style cumulative buckets (what
``serve/exporter.py`` renders as ``_bucket``/``_sum``/``_count``) that
also keep the raw observations, so ``snapshot()`` summarizes to exact
count/mean/p50/p99.

Counter names:

    submitted, completed, sheds, shed_queue_full, shed_memory,
    shed_retries, cancellations, deadline_misses_ttft,
    deadline_misses_total, errors_nonfinite, preemptions,
    kernel_fallbacks, spec_rows_disabled, spec_drafter_errors,
    watchdog_stalls

``Watchdog`` detects a STUCK engine: work is pending but no token has
been emitted (and no request has terminated) for longer than
``stall_s``. It kills nothing itself: it counts the stall and calls an
optional callback with its duration (the server's callback observes it
as a series and dumps the engine's flight recorder). The server feeds it
from its tick loop.
"""
from __future__ import annotations

import math
import time
from bisect import bisect_left
from collections import defaultdict
from typing import Callable, Dict, List, Optional


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list: the
    ceil(q/100 * n)-th smallest value (1-indexed)."""
    if not sorted_vals:
        return 0.0
    n = len(sorted_vals)
    idx = max(0, math.ceil(q / 100.0 * n) - 1)
    return sorted_vals[min(idx, n - 1)]


# Latency-oriented bucket bounds (seconds), ~1ms..60s. The exporter adds
# the implicit +Inf bucket.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Histogram:
    """Cumulative-bucket histogram that retains raw observations.

    ``bucket_counts[i]`` counts observations v with
    ``bounds[i-1] < v <= bounds[i]`` (non-cumulative storage; the
    exporter cumulates at render time per Prometheus ``le`` semantics).
    ``raw`` keeps every observation so snapshot percentiles stay exact —
    series here are per-request latencies, small by construction."""

    __slots__ = ("bounds", "bucket_counts", "sum", "count", "raw")

    def __init__(self, bounds=DEFAULT_BUCKETS):
        assert list(bounds) == sorted(bounds), "bucket bounds must ascend"
        self.bounds = tuple(float(b) for b in bounds)
        self.bucket_counts = [0] * len(self.bounds)
        self.sum = 0.0
        self.count = 0
        self.raw: List[float] = []

    def observe(self, value: float):
        v = float(value)
        self.raw.append(v)
        self.sum += v
        self.count += 1
        i = bisect_left(self.bounds, v)
        if i < len(self.bounds):
            self.bucket_counts[i] += 1
        # else: only the implicit +Inf bucket (== count) covers it

    def cumulative(self) -> List[int]:
        """Cumulative counts per bound (le semantics), excluding +Inf."""
        out, run = [], 0
        for c in self.bucket_counts:
            run += c
            out.append(run)
        return out

    def summary(self) -> dict:
        s = sorted(self.raw)
        return {
            "count": self.count,
            "mean": self.sum / self.count if self.count else 0.0,
            "p50": _percentile(s, 50),
            "p99": _percentile(s, 99),
        }


class ServeMetrics:
    """Monotonic counters + histogram series + last-value gauges, with a
    dict snapshot. Gauges carry optional labels — a (name, labels) pair
    is one series (``set_gauge("program_efficiency", 0.4,
    program="decode")`` and ``program="verify"`` coexist under one
    name), matching how serve/exporter.py renders them."""

    # Suffixes parse_prometheus classifies structurally — a gauge name
    # ending in one would round-trip as the wrong metric kind.
    _RESERVED = ("_total", "_bucket", "_sum", "_count")

    def __init__(self):
        self.counters: Dict[str, int] = defaultdict(int)
        self.series: Dict[str, Histogram] = defaultdict(Histogram)
        # name -> {sorted-label-items tuple -> (labels dict, value)}
        self.gauges: Dict[str, Dict[tuple, tuple]] = defaultdict(dict)

    def inc(self, name: str, n: int = 1):
        self.counters[name] += n

    def observe(self, name: str, value: float):
        self.series[name].observe(value)

    def set_gauge(self, name: str, value: float, **labels):
        assert not name.endswith(self._RESERVED), (
            f"gauge name {name!r} ends in a reserved Prometheus suffix"
        )
        key = tuple(sorted(labels.items()))
        self.gauges[name][key] = (dict(labels), float(value))

    def count(self, name: str) -> int:
        return self.counters.get(name, 0)

    def merge_counters(self, other: Dict[str, int]):
        """Adopt externally-owned counters (engine/backend/spec state) by
        OVERWRITE, not add — those objects own their counts; this surface
        just exports them."""
        for k, v in other.items():
            self.counters[k] = int(v)

    def merge_gauges(self, other: Dict[str, float], **labels):
        for k, v in other.items():
            self.set_gauge(k, v, **labels)

    def reset_counters(self):
        """Zero every counter, series and gauge in place (the same object,
        so references held elsewhere stay valid): the reset after a
        warm-up, so warm-up traffic never reaches the exported numbers."""
        self.counters.clear()
        self.series.clear()
        self.gauges.clear()

    def snapshot(self) -> dict:
        out: dict = dict(sorted(self.counters.items()))
        for name, hist in sorted(self.series.items()):
            out[name] = hist.summary()
        for name, variants in sorted(self.gauges.items()):
            vals = {}
            for _, (labels, value) in sorted(variants.items()):
                key = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                vals[key or "value"] = value
            out[name] = (vals["value"] if list(vals) == ["value"] else vals)
        return out


def collect_engine_metrics(engine, metrics: Optional[ServeMetrics] = None
                           ) -> ServeMetrics:
    """Merge a ServeEngine's robustness counters (preemptions, poisoned-
    row retirements, deadline misses, kernel fallbacks, spec
    degradations) into `metrics` (a fresh surface if None)."""
    m = metrics if metrics is not None else ServeMetrics()
    m.merge_counters(engine.robustness_stats())
    return m


class Watchdog:
    """Stuck-step detection for the serving tick loop.

    `beat(progressed, pending)` is called once per tick: ``progressed``
    means the engine emitted a token or changed request state this tick;
    ``pending`` means there is work that SHOULD be progressing. A stall
    fires when pending work sees no progress for `stall_s` seconds —
    a wedged device call, a scheduler livelock, a fault that ate a row.
    Firing is edge-triggered (once per stall episode, rearmed by the
    next progress) so a genuinely stuck engine does not spam.
    ``on_stall`` receives the stall duration in seconds; the server's
    callback records it as the ``watchdog_stall_s`` series and dumps the
    engine's flight recorder. ``last_stall_s`` keeps the most recent
    duration for introspection."""

    def __init__(self, stall_s: float = 30.0,
                 on_stall: Optional[Callable[[float], None]] = None):
        assert stall_s > 0
        self.stall_s = stall_s
        self.on_stall = on_stall
        self.stalls = 0
        self.last_stall_s = 0.0
        self._last_progress = time.perf_counter()
        self._armed = True

    def beat(self, progressed: bool, pending: bool) -> bool:
        """Returns True iff a stall fired on this beat."""
        now = time.perf_counter()
        if progressed or not pending:
            self._last_progress = now
            self._armed = True
            return False
        stalled_for = now - self._last_progress
        if self._armed and stalled_for >= self.stall_s:
            self.stalls += 1
            self.last_stall_s = stalled_for
            self._armed = False  # edge-triggered: rearm on next progress
            if self.on_stall is not None:
                self.on_stall(stalled_for)
            return True
        return False
