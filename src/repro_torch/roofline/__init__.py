"""Roofline of the port on the H100, counterpart of ``repro/roofline``:

  flops        — the analytic FLOP / HBM-byte model per (arch × shape)
  analysis     — the H100's data-sheet peaks, ``RooflineReport``,
                 ``model_flops`` and the serving programs' least times
  collectives  — the collectives a program emits, recorded as it runs
                 (the counterpart of the reference's HLO parse)
"""
from .analysis import (  # noqa: F401
    HBM_BW,
    INTER_NODE_BW,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    RooflineReport,
    model_flops,
    serving_program_bounds,
)
