"""The port's spans, step records and host timers.

``span(name)`` marks a region of the program, as a context manager or
as a decorator. Each span does three things:

* While a ``torch.profiler`` profile is recording, it opens a range of
  its name (``RecordFunctionFast``): a ``cpu_op`` on the profiler's
  clock, nested as the code nests. It is never a ``user_annotation``, so
  it puts no event on the device timeline: a profile's device ops, busy
  time and idle share read the same with the spans as without them, and
  the idle gaps of a profile are labelled by the innermost span or op
  open at their start. With no profile recording the span costs one
  check.
* It adds its call and its host time (``perf_counter_ns``) under its
  name to the open step record, if one is open. The host time includes
  any wait inside the span, a full launch queue's too.
* With ``device=True`` (the caller passes whether its tensors are on a
  CUDA device), while a profile is recording, it records a CUDA event on
  the current stream at entry and at exit, without a sync. The record
  keeps the pair; ``StepRecord.device_ms()`` reads the interval between
  the two. With no profile recording no event is made, so device
  intervals are a profile's, as the ranges are.

A span opened with ``root=True`` opens a step record if none is open,
and closes it into ``RECORDS``, a ring of the last 1024 step records.
The open record is one for the whole process, not one a thread:
autograd runs the backward of a CUDA graph (the backward kernels, the
remat recompute) on a thread of its own, and those spans belong to the
step that started it.

The spans of the port, by name (a profile shows them; the trainer logs
the host milliseconds of each from the last step record, and the device
milliseconds of the device spans while a profile records):

  train/step          root: one train step (``train/step.py``)
  train/forward       the loss function's forward
  train/backward      ``autograd.grad`` and the f32 cast of the gradients
  optim/adamw         device: the whole AdamW update (``optim/adamw.py``)
  optim/clip          the global-norm clip inside it
  optim/update        its leaf-by-leaf update loop
  soft_moe/<kernel>   each Soft-MoE kernel wrapper (routing_fwd,
                      combine_apply, combine_online, dispatch_bwd,
                      combine_bwd, routing_health), plain versions too
  soft_moe/experts    the experts of a Soft-MoE layer
  soft_moe/telemetry  device: the routing-health telemetry of a layer
  lm/logit_probes     device: the LM's per-row logit numerics
  vit/apply           root: one ViT forward (a record of its own in
                      inference, nested in ``train/step`` in training)

``FlightRecorder`` and ``ProgramTimer`` live here and are re-exported by
``serve/tracing.py``; a ``ProgramTimer`` call is a span of its name.
"""
from __future__ import annotations

import functools
import json
import time
from collections import deque
from typing import Dict, List, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


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

    def record(self, rec):
        self.ticks += 1
        self._ring.append(rec)

    def records(self) -> List:
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
        """Compact text table of the most recent tick records — of the
        live ring, or of an explicit record list (e.g. a frozen
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


# -- step records and spans --------------------------------------------------


class StepRecord:
    """One root span's counters, by span name: ``calls``, ``host_ns``
    and, for the device spans opened while a profiler recorded, their
    CUDA event pairs, which ``device_ms()`` reads."""

    __slots__ = ("calls", "host_ns", "pairs")

    def __init__(self):
        self.calls: Dict[str, int] = {}
        self.host_ns: Dict[str, int] = {}
        self.pairs: list = []  # (name, start event, end event)

    def host_ms(self) -> Dict[str, float]:
        return {k: v / 1e6 for k, v in self.host_ns.items()}

    def device_ms(self) -> Dict[str, float]:
        """Milliseconds between each device span's two events, summed by
        name. Waits for the events, so read it once the step's work is
        wanted anyway (after a sync on its loss)."""
        out: Dict[str, float] = {}
        for name, start, end in self.pairs:
            start.synchronize()
            end.synchronize()
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


RECORDS: deque = deque(maxlen=1024)  # the last step records, oldest first
_open: Optional[StepRecord] = None


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def step_records(n: int) -> List[StepRecord]:
    """The last ``n`` step records, or as many as the ring holds."""
    recs = list(RECORDS)
    return recs[len(recs) - min(n, len(recs)):]


class _Span:
    """One span; ``span()`` makes it. Used as a decorator, it opens a
    fresh span of the same name around each call."""

    __slots__ = ("name", "device", "root", "_t0", "_range", "_start",
                 "_owner")

    def __init__(self, name: str, device: bool = False, root: bool = False):
        self.name, self.device, self.root = name, device, root

    def __enter__(self):
        global _open
        self._owner = self.root and _open is None
        if self._owner:
            _open = StepRecord()
        self._range = self._start = None
        if _profiling():
            self._range = _Range(self.name)
            self._range.__enter__()
            if self.device and _open is not None:
                self._start = _event()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _open
        dt = time.perf_counter_ns() - self._t0
        rec = _open
        if rec is not None:
            rec.calls[self.name] = rec.calls.get(self.name, 0) + 1
            rec.host_ns[self.name] = rec.host_ns.get(self.name, 0) + dt
            if self._start is not None:
                rec.pairs.append((self.name, self._start, _event()))
        if self._range is not None:
            self._range.__exit__(None, None, None)
        if self._owner:
            _open = None
            RECORDS.append(rec)
        return False

    def __call__(self, fn):
        name, device, root = self.name, self.device, self.root

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with _Span(name, device, root):
                return fn(*args, **kwargs)

        return wrapper


def span(name: str, *, device: bool = False, root: bool = False) -> _Span:
    """A span of ``name`` (the module docstring says what it records);
    ``device`` records CUDA events on the current stream at its ends
    while a profile records, ``root`` opens a step record if none is
    open."""
    return _Span(name, device, root)


# -- per-program host timing -------------------------------------------------


class ProgramTimer:
    """Wrap one program with host-side wall-time accounting.

    ``calls``/``total_s`` accumulate for the wrapper's lifetime;
    ``take_tick()`` drains the per-tick delta the flight recorder
    stores. Unknown attributes pass through to the wrapped callable.
    Each call is a span of the timer's name, so a profile shows it.

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
        with span(self.name):
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
