"""The serving programs' least times on the H100, counterpart of
``serving_program_bounds`` in the JAX package's ``roofline/analysis.py``
(which targets its own chip). The rest of that package (the dry-run
roofline terms from compiled artifacts) is not ported.
"""
from __future__ import annotations

from typing import Dict

# The H100's published dense bf16 rate and HBM bandwidth (NVIDIA data
# sheet, SXM part, 700 W).
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12


def serving_program_bounds(cfg, batch: int, prefill_chunk: int,
                           verify_lanes: int = 1,
                           dtype_bytes: int = 2) -> Dict[str, float]:
    """Least seconds ONE call of each serving program could take on the
    H100, ``max(2 N_active tokens / PEAK_FLOPS_BF16, N_active
    dtype_bytes / HBM_BW)``. Tokens a call: ``batch`` for decode (one a
    row), ``prefill_chunk`` for a prefill chunk (batch 1),
    ``batch * verify_lanes`` for a verify. The bytes are the active
    weights read once; K/V reads are left out, so the bound is
    optimistic. ``ServeEngine.program_efficiency()`` divides these by
    the ``ProgramTimer`` host times."""
    n_active = cfg.active_param_count()

    def bound(tokens: int) -> float:
        return max(2.0 * n_active * tokens / PEAK_FLOPS_BF16,
                   n_active * dtype_bytes / HBM_BW)

    return {"decode": bound(batch), "prefill_chunk": bound(prefill_chunk),
            "verify": bound(batch * verify_lanes)}
