"""Tile policy of the port's kernels on Hopper, counterpart of
``repro/kernels/tuning.py``.

Soft-MoE kernels (K1 routing, K2/K3 combine, K4/K5 their backward;
kernels/soft_moe_kernels.py):
``block_tokens`` and ``block_slots`` have the JAX fields' meaning (the
token and slot blocks of the online softmaxes), so a test can pin the
plain versions to the TPU kernel's tiling. The CUDA kernels take blocks
of at most 32 (``SOFT_MOE_TILE``: one warp lane per token or slot in the
softmax steps); the Hopper default is 32 for both, clamped to the
problem as the JAX heuristic clamps.

The routing kernel (K1) cuts a row's tokens into chunks of
``routing_chunk(m, S, block_tokens)`` tokens and its slots into slot
tiles of ``block_slots``, one CUDA block per (chunk, slot tile, row): the
block forms its logits once over the whole of d, takes the chunk's
dispatch softmax and writes the chunk's slots; where a row has several
chunks a second pass merges them in chunk order. A chunk is at least
``FWD_TILES`` token blocks and at least 2 S tokens (a chunk's slot
partials, S d f32 written and read, then cost at most twice its bf16
tokens), at most ``ROUTING_MAX_CHUNK`` tokens (its logits tile lives in
shared memory) and at most the row: the ViTs' rows (m = 196, S = 128)
are one chunk and write no partials, the granite LM layer's (m = 2048,
S = 32) 32 chunks of 64 tokens. The combine from saved stats (K2) takes
chunks of ``combine_chunk(block_tokens)`` tokens, ``FWD_TILES`` token
blocks, one CUDA block per (chunk, row); its tokens need no partials.
The CUDA sources hold the same caps: ``ROUTING_MAX_CHUNK`` is
``kMaxChunk`` of csrc/soft_moe_routing.cu, and K2's chunk, at most
``FWD_TILES * SOFT_MOE_TILE`` = 64 tokens, is bounded by ``kCT`` of
csrc/soft_moe_combine.cu; each C entry point refuses a larger chunk. Neither depends on the batch, so a row's
outputs do not either.

The online combine (K3) keeps the d-chunk design: a TPU tile holds a
whole row of d, but at d = 768 a (128 x 768) f32 accumulator is 393 KB
against the 227 KB of shared memory a block may use, so each CUDA block
accumulates one chunk of d for a 32-token block, in registers, and
recomputes the logits tile once per chunk: a factor ceil(d / chunk) on
the logits arithmetic. It is built for chunks of 128, 256, 384 and 768
columns (``D_CHUNKS``); ``d_chunk(d)`` takes the narrowest one that
covers d, so up to d = 768 there is one chunk and no recompute, and
wider rows (L/16's 1024, H/14's 1280) use 768-column chunks.

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
row order. They take no d-chunk: ``D_CHUNKS`` and ``d_chunk()`` are
K3's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


SOFT_MOE_TILE = 32  # largest token / slot block of the CUDA kernels
D_CHUNKS = (128, 256, 384, 768)  # d-chunk widths K3 is built for
FWD_TILES = 2  # token blocks of a K2 chunk and of the smallest K1 chunk
ROUTING_MAX_CHUNK = 256  # most tokens of a K1 chunk (kMaxChunk)
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
    """Columns of d one block of the online combine (K3) accumulates: the
    narrowest built width that covers d, or the widest where none does."""
    return next((w for w in D_CHUNKS if w >= d), D_CHUNKS[-1])


def routing_chunk(m: int, s: int, bt: int) -> int:
    """Tokens of one chunk of the routing kernel (K1) for m tokens, S
    slots and token blocks of bt: whole token blocks, at least
    ``FWD_TILES`` of them and at least 2 S tokens, at most
    ``ROUTING_MAX_CHUNK`` tokens and at most the row."""
    want = max(FWD_TILES * bt, _round_up(2 * s, bt))
    return min(want, ROUTING_MAX_CHUNK // bt * bt, _round_up(m, bt))


def combine_chunk(bt: int) -> int:
    """Tokens of one chunk of the combine kernel (K2) for token blocks of
    bt: ``FWD_TILES`` token blocks, whatever m and the batch."""
    return FWD_TILES * bt


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
