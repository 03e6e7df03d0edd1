"""Tile policy of the port's kernels on Hopper, counterpart of
``repro/kernels/tuning.py``.

Soft-MoE kernels (K1 routing, K2/K3 combine, K4/K5 their backward;
kernels/soft_moe_kernels.py):
``block_tokens`` and ``block_slots`` have the JAX fields' meaning (the
token and slot blocks of the online softmaxes), so a test can pin the
plain versions to the TPU kernel's tiling. The CUDA kernels hold a
32 x 32 logits tile (one warp lane per token or slot in the softmax
steps, four logits per thread of 256), so they take blocks of at most 32
(``SOFT_MOE_TILE``); the Hopper default is 32 for both, clamped to the
problem as the JAX heuristic clamps. The d-chunk is not a setting: a TPU
tile holds a whole row of d, but at d = 768 a (128 x 768) f32
accumulator is 393 KB against the 227 KB of shared memory a block may
use, so each CUDA block accumulates one chunk of d for a 32-slot (or
32-token) block, in registers, and recomputes the logits tile once per
chunk: a factor ceil(d / chunk) on the logits arithmetic. The kernels
are built for chunks of 128, 256, 384 and 768 columns (``D_CHUNKS``);
``d_chunk(d)`` takes the narrowest one that covers d, so up to d = 768
there is one chunk and no recompute, and wider rows (L/16's 1024, H/14's
1280) use 768-column chunks.

``paged_block_kv`` is the number of KV rows one online-softmax update of
the paged decode kernel folds in. Pool blocks of up to 128 rows (the
serving default is 16) are one tile; larger blocks are cut into the
largest divisor <= 128, the same policy as the TPU kernel, so both
kernels fold keys in the same groups. On Hopper the kernel stages
several such tiles in shared memory at once (up to 128 keys) and keeps
the per-tile update order, so the staging width does not change the
arithmetic. There is no interpret mode: a CPU tensor runs the plain
PyTorch version of each kernel.

The routing-health kernel (K6) reduces a row's tokens in chunks of
``HEALTH_TILES`` token blocks, one CUDA block per (chunk, slot block,
row), and sums the chunks' partials in chunk order; the chunk does not
depend on the batch, so a row's statistics do not either.

The backward kernels (K4, K5) split a row's tokens the same way, in
chunks of ``BWD_TILES`` token blocks (64 tokens at the default 32-token
block), one CUDA block per (chunk, row): it builds its chunk's weights
for every slot once and writes dX and the chunk's dPhi_n (and dYs)
partials, which a second pass sums in chunk order, then over rows in
row order. They take no d-chunk: ``D_CHUNKS`` and ``d_chunk()`` are the
forward kernels'.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


SOFT_MOE_TILE = 32  # largest token / slot block of the CUDA kernels
D_CHUNKS = (128, 256, 384, 768)  # d-chunk widths the kernels are built for
HEALTH_TILES = 2  # token blocks one block of the routing-health kernel reduces
BWD_TILES = 2  # token blocks of one chunk of the backward kernels K4, K5


@dataclass(frozen=True)
class KernelConfig:
    """Per-call kernel policy. ``paged_block_kv`` 0 means "derive from
    the pool's block size" (``paged_config``)."""

    block_tokens: int = SOFT_MOE_TILE
    block_slots: int = SOFT_MOE_TILE
    acc_dtype: str = "float32"  # accumulator / softmax-stat dtype
    paged_block_kv: int = 0

    def acc(self) -> torch.dtype:
        return {"float32": torch.float32}[self.acc_dtype]

    def replace(self, **kw) -> "KernelConfig":
        return dataclasses.replace(self, **kw)


def default_config(m: int, d: int, s: int,
                   base: Optional[KernelConfig] = None) -> KernelConfig:
    """Block sizes for a (tokens, d_model, slots) problem: the base's
    blocks clamped to the problem (multiples of 8, as the JAX heuristic
    clamps them)."""
    cfg = base or KernelConfig()
    bt = max(8, min(cfg.block_tokens, _round_up(m, 8)))
    bs = max(8, min(cfg.block_slots, _round_up(s, 8)))
    return cfg.replace(block_tokens=bt, block_slots=bs)


def d_chunk(d: int) -> int:
    """Columns of d one Soft-MoE CUDA block accumulates: the narrowest
    built width that covers d, or the widest where none does."""
    return next((w for w in D_CHUNKS if w >= d), D_CHUNKS[-1])


def config_from_moe(moe_cfg, m: int, d: int) -> KernelConfig:
    """KernelConfig from the MoEConfig fields (0 = the default policy)."""
    base = KernelConfig(acc_dtype=moe_cfg.kernel_acc_dtype)
    cfg = default_config(m, d, moe_cfg.total_slots(), base)
    if moe_cfg.kernel_block_tokens:
        cfg = cfg.replace(block_tokens=moe_cfg.kernel_block_tokens)
    if moe_cfg.kernel_block_slots:
        cfg = cfg.replace(block_slots=moe_cfg.kernel_block_slots)
    return cfg


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


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
