"""Tile policy of the port's kernels on Hopper, counterpart of
``repro/kernels/tuning.py`` (only the paged decode-attention part of it
so far).

``paged_block_kv`` is the number of KV rows one online-softmax update of
the paged decode kernel folds in. Pool blocks of up to 128 rows (the
serving default is 16) are one tile; larger blocks are cut into the
largest divisor <= 128, the same policy as the TPU kernel, so both
kernels fold keys in the same groups. On Hopper the kernel stages
several such tiles in shared memory at once (up to 128 keys) and keeps
the per-tile update order, so the staging width does not change the
arithmetic. There is no interpret mode: a CPU tensor runs the plain
PyTorch version of each kernel.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class KernelConfig:
    """Per-call kernel policy. ``paged_block_kv`` 0 means "derive from the
    pool's block size" (``paged_config``)."""

    acc_dtype: str = "float32"  # accumulator / softmax-stat dtype
    paged_block_kv: int = 0

    def acc(self) -> torch.dtype:
        return {"float32": torch.float32}[self.acc_dtype]

    def replace(self, **kw) -> "KernelConfig":
        return dataclasses.replace(self, **kw)


def paged_config(block_size: int,
                 base: Optional[KernelConfig] = None) -> KernelConfig:
    """Tile policy for the paged decode-attention kernel
    (kernels/paged_attention.py): whole pool blocks of up to 128 rows;
    larger blocks are subdivided into the LARGEST divisor <= 128 (every
    block size has one, worst case 1)."""
    cfg = base or KernelConfig()
    bkv = cfg.paged_block_kv
    if not bkv:
        bkv = block_size
        if block_size > 128:
            bkv = next(c for c in range(128, 0, -1) if block_size % c == 0)
    if block_size % bkv != 0:
        raise ValueError(
            f"paged_block_kv {bkv} must divide pool block_size {block_size}"
        )
    return cfg.replace(paged_block_kv=bkv)
