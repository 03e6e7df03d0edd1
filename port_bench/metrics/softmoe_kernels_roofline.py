"""The Soft-MoE kernels K1-K6 against their bounds: over every wrapper
call of the traced window, the sum of the calls' bounds over the sum of
the device time of the launches made inside them. A call's bound is
``flops.soft_moe_kernel_bound`` of its arguments and result."""
from port_bench.flops import soft_moe_kernel_bound
from port_bench.trace import range_share

_OPS = "repro_torch.kernels.ops"
# (wrapper kernel, the name it is called by in kernels/ops.py)
_KERNELS = [("routing_fwd", "routing_fwd"), ("combine_apply", "combine_apply"),
            ("combine_online", "combine_online"),
            ("dispatch_bwd", "dispatch_bwd"), ("combine_bwd", "combine_bwd"),
            ("routing_health", "_routing_health")]


def _bound(kernel):
    return lambda args, kwargs, out: soft_moe_kernel_bound(kernel, args, out)


WRAPS = [(f"softmoe.{k}", _OPS, attr, _bound(k)) for k, attr in _KERNELS]


def read(ctx):
    return range_share(ctx, "softmoe.")
