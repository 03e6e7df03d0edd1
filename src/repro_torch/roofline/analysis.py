"""Roofline terms at the H100's published peaks, counterpart of
``repro/roofline/analysis.py`` (which targets a TPU v5e):

  compute term    = FLOPs_per_device / PEAK_FLOPS_BF16
  memory term     = bytes_per_device / HBM_BW
  collective term = NVLink-weighted bytes / NVLINK_BW
                    + pod-crossing weighted bytes / INTER_NODE_BW

Every constant is a data-sheet figure for one H100 SXM (NVIDIA's H100
data sheet and the DGX H100 system's), none is measured: the dense bf16
tensor-core rate, the HBM3 bandwidth, NVLink's 900 GB/s bidirectional
taken as 450 GB/s a direction, and a DGX H100 node's eight 400 Gb/s
network links for its eight GPUs, 50 GB/s a GPU. Like the reference,
which prices a pod's collectives at the ICI rate, the model treats one
pod of ranks as one NVLink domain and prices only the collectives whose
group spans pods at the inter-node rate.

The port has no compiled program: FLOPs and bytes come from the analytic
model (``roofline/flops.py``) and the collectives from the ops the
program emits (``roofline/collectives.py``). The reference's
``parse_collectives`` reads optimized HLO text and has no counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

# H100 SXM data sheet (700 W): dense bf16 rate, HBM3 bandwidth
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
# NVLink 4: 900 GB/s bidirectional per GPU, one direction
NVLINK_BW = 450e9
# DGX H100: eight 400 Gb/s links for eight GPUs, per GPU
INTER_NODE_BW = 50e9


@dataclass
class RooflineReport:
    name: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_weighted: float
    model_flops_total: float  # 6·N·D (or 6·N_active·D)
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_weighted / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / total FLOPs across devices — catches remat and
        redundancy waste (>1/3 is typical with full remat:
        fwd+bwd+rematfwd)."""
        total = self.flops_per_device * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline realized if the program ran at
        the bound: t_compute / max(all terms)."""
        return self.t_compute / self.t_bound if self.t_bound else 0.0

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_weighted": self.collective_bytes_weighted,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops_total,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


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


def model_flops(cfg, shape, mode: str) -> float:
    """6·N·D for training; 2·N·D for one forward (prefill); 2·N_active per
    decoded token. N = active params (MoE-aware)."""
    n_active = cfg.active_param_count()
    if mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
