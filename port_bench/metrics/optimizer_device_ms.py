"""The optimizer's device interval a step: the milliseconds between the
CUDA events the program's span ``optim/adamw`` records on its stream at
the call's entry and exit, the median over the window's traced steps
(the program records device events only while a profile records). On a
device that keeps pace with the host this is AdamW's device time; where
the host paces the step it also holds the idle time between the
optimizer's launches."""
from port_bench.metrics.optimizer_host_ms import span_median


def read(ctx):
    return span_median(ctx, lambda rec: rec.device_ms().get("optim/adamw"),
                       traced=True)
