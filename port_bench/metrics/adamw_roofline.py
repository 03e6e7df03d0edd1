"""The optimizer against its bound: over every ``adamw_update`` call of
the traced window (``train/step.py`` calls it once a step), the sum of
the calls' bounds (``flops.adamw_bound``: the clip's read of the
gradients, then every leaf's gradient, param and moments read and the
param and moments written) over the device time of the launches made
inside the calls."""
from port_bench.flops import adamw_bound
from port_bench.trace import range_share


def _bound(args, kwargs, out):
    grads, opt, params = args[0], args[1], args[2]
    return adamw_bound(grads, opt["mu"], opt["nu"], params)


WRAPS = [("adamw", "repro_torch.train.step", "adamw_update", _bound)]


def read(ctx):
    return range_share(ctx, "adamw")
