"""Model FLOPs per step (``flops.step_flops``, the benchmark's own
count) times the traced steps, over the traced window, as a share of
the bf16 dense peak."""
from port_bench.flops import BF16_PEAK


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return (100.0 * ctx["flops_per_step"] * ctx["steps_traced"]
            / tr["window_s"] / BF16_PEAK)
