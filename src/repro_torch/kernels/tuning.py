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
S = 32) 32 chunks of 64 tokens. Both combines, from saved stats (K2) and
online (K3), run one body: chunks of ``combine_chunk(block_tokens)``
tokens, ``FWD_TILES`` token blocks, one CUDA block per (chunk, row),
which forms its logits once over the whole of d and needs no partials;
K3 carries its online (max, denom) over the body's 128-slot tiles, not
over ``block_slots``. The CUDA sources hold the same caps:
``ROUTING_MAX_CHUNK`` is ``kMaxChunk`` of csrc/soft_moe_routing.cu, and
the combine chunk, at most ``FWD_TILES * SOFT_MOE_TILE`` = 64 tokens, is
bounded by ``kCT`` of csrc/soft_moe_combine.cu and of
csrc/soft_moe_routing_health.cu; each C entry point
refuses a larger chunk. Neither depends on the batch, so a row's
outputs do not either.

``paged_block_kv`` is the number of KV rows of one tile of the paged
decode kernel (K7). Pool blocks of up to 128 rows (the serving default
is 16) are one tile; larger blocks are cut into the largest divisor <=
128, the same policy as the TPU kernel. On Hopper the kernel splits each
row's keys (split-KV): a split is ``paged_split_tiles(paged_block_kv)``
whole tiles, as many as fit in ``PAGED_SPLIT_KEYS`` (128 keys at the
serving block of 16), one CUDA block per (KV group, split, row), and a
second pass merges a row's split partials in split order. The split
depends on the pool's tiling alone, never on the batch or on the other
rows' lengths, so neither does a row's output. There is no interpret
mode: a CPU tensor runs the plain PyTorch version of each kernel.

The routing-health kernel (K6) runs K2's body on the same chunks of
``combine_chunk(block_tokens)`` tokens, one CUDA block per (chunk,
row): it forms each 128-slot tile's logits once over the whole of d,
carries each token's sums across the tiles and writes each chunk's
per-slot sums, which a second pass adds in chunk order. The chunk does
not depend on the batch, so a row's statistics do not either.

The backward kernels (K4, K5) split a row's tokens the same way, in
chunks of ``BWD_TILES`` token blocks (64 tokens at the default 32-token
block), one CUDA block per (chunk, row): it builds its chunk's weights
for every slot once and writes dX and the chunk's dPhi_n (and dYs)
partials, which a second pass sums in chunk order, then over rows in
row order.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch


SOFT_MOE_TILE = 32  # largest token / slot block of the CUDA kernels
FWD_TILES = 2  # token blocks of a K2/K3/K6 chunk and of the smallest K1 chunk
ROUTING_MAX_CHUNK = 256  # most tokens of a K1 chunk (kMaxChunk)
BWD_TILES = 2  # token blocks of one chunk of the backward kernels K4, K5
PAGED_SPLIT_KEYS = 128  # most keys of one split of K7 (a whole tile more)


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


def routing_chunk(m: int, s: int, bt: int) -> int:
    """Tokens of one chunk of the routing kernel (K1) for m tokens, S
    slots and token blocks of bt: whole token blocks, at least
    ``FWD_TILES`` of them and at least 2 S tokens, at most
    ``ROUTING_MAX_CHUNK`` tokens and at most the row."""
    want = max(FWD_TILES * bt, _round_up(2 * s, bt))
    return min(want, ROUTING_MAX_CHUNK // bt * bt, _round_up(m, bt))


def combine_chunk(bt: int) -> int:
    """Tokens of one chunk of the combine kernels (K2, K3) and of the
    routing-health kernel (K6) for token blocks of bt: ``FWD_TILES``
    token blocks, whatever m, d and the batch."""
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


def paged_split_tiles(paged_block_kv: int) -> int:
    """Tiles of ``paged_block_kv`` keys one split of the paged decode
    kernel (K7) covers: as many as fit in ``PAGED_SPLIT_KEYS``, at least
    one. A function of the pool's tiling alone."""
    return max(1, PAGED_SPLIT_KEYS // paged_block_kv)


# -- autotune sweep hook -----------------------------------------------------

# (block_tokens, block_slots) candidates: the Hopper kernels take blocks of
# at most SOFT_MOE_TILE (one warp lane per token or slot)
DEFAULT_SWEEP: Sequence[tuple] = (
    (8, 32), (16, 16), (16, 32), (32, 8), (32, 16), (32, 32),
)


def _first_tensor(out):
    """``out`` itself or the first tensor of a (nested) tuple or list."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def _seconds_per_call(fn: Callable, iters: int) -> float:
    """Mean seconds of ``fn()`` after one warm-up call (which builds a
    kernel at first use): CUDA events when it returns a CUDA tensor, the
    host clock otherwise."""
    first = _first_tensor(fn())
    if first is not None and first.device.type == "cuda":
        with torch.cuda.device(first.device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def autotune(build_fn: Callable[[KernelConfig], Callable[[], object]],
             base: Optional[KernelConfig] = None,
             sweep: Sequence[tuple] = DEFAULT_SWEEP,
             iters: int = 3) -> KernelConfig:
    """Time ``build_fn(cfg)()`` for each (block_tokens, block_slots) of the
    sweep and return the fastest config (``base`` if none runs).
    ``build_fn`` returns a nullary thunk over real operands; a warm-up
    call keeps the kernel's build out of the time. Candidates above
    ``SOFT_MOE_TILE``, which the kernels refuse, are not tried; a
    candidate that raises is skipped rather than fatal, as in the
    reference. Offline use only (a benchmark, start-up): it synchronizes
    around each candidate."""
    base = base or KernelConfig()
    best, best_t = base, float("inf")
    for bt, bs in sweep:
        if max(bt, bs) > SOFT_MOE_TILE:
            continue
        cfg = base.replace(block_tokens=bt, block_slots=bs)
        try:
            dt = _seconds_per_call(build_fn(cfg), iters)
        except Exception:  # noqa: BLE001 — skip tilings the kernel refuses
            continue
        if dt < best_t:
            best, best_t = cfg, dt
    return best
