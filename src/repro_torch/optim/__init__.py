"""Optimizer of the port, counterpart of ``repro/optim``: AdamW (the
gradient compression of ``repro/optim/compression.py`` is not ported)."""
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
