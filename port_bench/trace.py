"""The traced part of a run: ranges opened around program functions from
the benchmark's own files, the profiler's device trace, and its
reduction to busy time, per-range device time and the breakdown.

``Ranges`` patches named functions of the program for the traced steps
only: each call runs inside ``torch.profiler.record_function`` under a
name of its own (``pb:<key>#<n>``), and the call's bound is computed from
its arguments and result. After the trace, every device operation is
charged to the range in which its launch was made (the runtime call that
shares its correlation id), so a range's device time is the time of the
launches made inside the call.

The reductions below work on plain tuples, so a CPU test can hold them to
hand-made traces.
"""
from __future__ import annotations

import bisect
import importlib
import re

PREFIX = "pb:"
WINDOW = PREFIX + "window"
_INDEX = re.compile(r"#\d+$")
NAME_CHARS = 120  # kernel names are cut to this for the breakdown


class Ranges:
    """Context: ``wraps`` is [(key, module, attribute, bound_fn)], where
    ``bound_fn(args, kwargs, result)`` gives the call's bound in seconds.
    Afterwards ``bounds`` maps each range name to its call's bound."""

    def __init__(self, wraps):
        self.wraps = wraps
        self.bounds = {}
        self._saved = []

    def __enter__(self):
        import torch

        for key, mod_name, attr, bound_fn in self.wraps:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)

            def wrapped(*args, _orig=orig, _key=key, _bound=bound_fn,
                        **kwargs):
                name = f"{PREFIX}{_key}#{len(self.bounds)}"
                with torch.profiler.record_function(name):
                    out = _orig(*args, **kwargs)
                self.bounds[name] = _bound(args, kwargs, out)
                return out

            self._saved.append((mod, attr, orig))
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []


# --- the kineto trace as tuples ---------------------------------------------

def events_of(prof):
    """(cpu, device) event tuples of a finished ``torch.profiler.profile``.

    cpu: (start_ns, end_ns, name, correlation_id, thread)
    device: (start_ns, end_ns, name, correlation_id, linked_id)
    """
    from torch.autograd import DeviceType

    cpu, dev = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        row = (start, start + ev.duration_ns(), ev.name())
        if ev.device_type() == DeviceType.CPU:
            cpu.append(row + (ev.correlation_id(), ev.start_thread_id()))
        elif not ev.name().startswith(PREFIX):  # not a gpu_user_annotation
            dev.append(row + (ev.correlation_id(),
                              ev.linked_correlation_id()))
    return cpu, dev


def _is_runtime(name: str) -> bool:
    return name.startswith(("cuda", "cu")) and not name.startswith("cutlass")


def reduce_trace(cpu, dev):
    """The traced window's numbers from event tuples.

    Returns {"window_s", "busy_s", "range_device_s": {range name: s},
    "device_ops": [[name, s]] top 10, "idle_gaps": [[label, s]] top 10,
    "attributed": device ops charged to some range, "device_ops_n"}."""
    win = [e for e in cpu if e[2] == WINDOW]
    if not win:
        raise ValueError("trace holds no window range")
    w0, w1 = win[0][0], win[0][1]
    dev = [e for e in dev if e[1] > w0 and e[0] < w1]
    # busy: the union of the device intervals inside the window
    spans = sorted((max(s, w0), min(e, w1)) for s, e, *_ in dev)
    busy, gaps, cur = 0, [], None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], s))
            else:
                gaps.append((w0, s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
        gaps.append((cur[1], w1))
    else:
        gaps.append((w0, w1))
    # each device op's launch: the runtime call with its correlation id
    # (or, failing that, the CPU op its linked id names)
    launch = {e[3]: e[0] for e in cpu if _is_runtime(e[2])}
    op_at = {e[3]: e[0] for e in cpu if not _is_runtime(e[2])}
    ranges = sorted((e[0], e[1], e[2]) for e in cpu
                    if e[2].startswith(PREFIX) and e[2] != WINDOW)
    starts = [r[0] for r in ranges]
    per_range, attributed = {}, 0
    by_name = {}
    for s, e, name, corr, linked in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
        t = launch.get(corr, op_at.get(linked))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and ranges[i][1] >= t:
            key = ranges[i][2]
            per_range[key] = per_range.get(key, 0) + (e - s)
            attributed += 1
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "range_device_s": {k: v / 1e9 for k, v in per_range.items()},
        "device_ops": [[n[:NAME_CHARS], v / 1e9] for n, v in top_ops],
        "idle_gaps": label_gaps(cpu, gaps),
        "attributed": attributed,
        "device_ops_n": len(dev),
    }


def label_gaps(cpu, gaps, longest: int = 400):
    """The idle gaps' seconds summed by what the host was doing at each
    gap's start (the innermost op or range open then; ``#n`` dropped),
    over the ``longest`` gaps; top 10."""
    ops = sorted((e[0], e[1], e[2]) for e in cpu
                 if not _is_runtime(e[2]) and e[2] != WINDOW)
    starts = [o[0] for o in ops]
    out = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:longest]:
        label = "host outside any op"
        i = bisect.bisect_right(starts, g0) - 1
        for j in range(i, max(i - 4000, -1), -1):
            if ops[j][1] >= g0:
                label = _INDEX.sub("", ops[j][2])
                break
        out[label] = out.get(label, 0) + (g1 - g0)
    top = sorted(out.items(), key=lambda kv: -kv[1])[:10]
    return [[n, v / 1e9] for n, v in top]


def range_share(ctx, prefix):
    """100 x sum of bounds / sum of device time over the ranges whose key
    starts with ``prefix``; None where no launch was charged to one."""
    tr = ctx.get("trace")
    if not tr:
        return None
    bound = dev = 0.0
    for name, secs in tr["range_device_s"].items():
        if name[len(PREFIX):].startswith(prefix) and secs > 0:
            bound += ctx["bounds"][name]
            dev += secs
    return 100.0 * bound / dev if dev > 0 else None
