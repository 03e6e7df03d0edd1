"""The Soft-MoE kernel wrappers' host time a step: the milliseconds of
the program's six ``soft_moe/<wrapper>`` spans summed (K1-K6, each
wrapper's operand checks, scratch allocations and launch), the median
over the window's untraced steps or inference batches."""
from port_bench.metrics.optimizer_host_ms import span_median

SPANS = tuple(f"soft_moe/{k}" for k in (
    "routing_fwd", "combine_apply", "combine_online", "dispatch_bwd",
    "combine_bwd", "routing_health"))


def _sum(rec):
    host = rec.host_ms()
    found = [host[s] for s in SPANS if s in host]
    return sum(found) if found else None


def read(ctx):
    return span_median(ctx, _sum)
