"""Optimizer of the port, counterpart of ``repro/optim``: AdamW and the
int8 error-feedback compression of the cross-pod gradient reduce."""
from .adamw import (  # noqa: F401
    OptimizerConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    schedule_lr,
    tree_leaves,
    tree_map,
)
from .compression import (  # noqa: F401
    compress_with_feedback,
    dequantize_int8,
    ef_state_init,
    pod_allreduce_compressed,
    pod_allreduce_mean,
    quantize_int8,
)
