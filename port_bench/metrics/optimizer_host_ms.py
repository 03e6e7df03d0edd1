"""The optimizer's host time a step: the milliseconds of the program's
span ``optim/adamw`` (``repro_torch/tracing.py``), the whole AdamW call
from its first launch to its return, waits on a full launch queue
included. Read from the program's step records of the window's untraced
steps (the profiler's host cost stretches the traced ones), as their
median. ``span_median`` serves the other readers of the program's
spans."""
import statistics


def window_records(ctx, traced=False):
    """The program's step records of the window's traced steps, or of
    its untraced ones, one a step, oldest first; [] where there is
    nothing to read: a run with no card's trace (the CPU), no such step,
    or a program without step records."""
    if not ctx.get("trace"):
        return []
    try:
        from repro_torch import tracing
    except ImportError:
        return []
    n, k = ctx["window"]["steps"], ctx["steps_traced"]
    if traced:  # the window's first steps
        recs = tracing.step_records(n)
        return recs[:k] if len(recs) == n else []
    return tracing.step_records(n - k) if n > k else []


def span_median(ctx, value, traced=False):
    """The median of ``value(record)`` over the window's untraced (or
    traced) step records, leaving out the records it gives None for;
    None where none is left."""
    values = [v for v in map(value, window_records(ctx, traced))
              if v is not None]
    return statistics.median(values) if values else None


def read(ctx):
    return span_median(ctx, lambda rec: rec.host_ms().get("optim/adamw"))
