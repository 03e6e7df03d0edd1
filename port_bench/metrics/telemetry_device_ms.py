"""The telemetry's device intervals a step: the milliseconds between
the CUDA events of the program's spans ``soft_moe/telemetry`` (each
Soft-MoE layer's routing health, K6 and its reductions) and
``lm/logit_probes`` (the per-row logit numerics), summed over a step,
the median over the window's traced steps (the program records device
events only while a profile records)."""
from port_bench.metrics.optimizer_host_ms import span_median

SPANS = ("soft_moe/telemetry", "lm/logit_probes")


def _sum(rec):
    dev = rec.device_ms()
    found = [dev[s] for s in SPANS if s in dev]
    return sum(found) if found else None


def read(ctx):
    return span_median(ctx, _sum, traced=True)
