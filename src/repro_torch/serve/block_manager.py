"""Paged serving memory: fixed-size KV token blocks + per-request tables,
counterpart of ``repro/serve/block_manager.py``.

``BlockManager`` is a copy of the JAX package's host-side allocator
(refcounts, copy-on-write bookkeeping). ``PagedBackend`` owns the device
side: per-layer block pools, the per-slot block tables and the eager
paged prefill/decode/clear/copy programs. The pools are updated IN
PLACE by those programs (the JAX package replaces them functionally and
donates the old buffers; nothing here needs donation).

Unlike the JAX backend there is no permanent kernel-to-gather fallback:
with ``use_kernel=True`` a kernel that fails to build or launch raises
out of ``decode`` (the engine retires the rows of the failed call).
``use_kernel=False`` is the caller's explicit choice of the gather path,
the oracle the kernel is tested against.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..layers.attention import init_paged_kv_cache
from ..layers.common import resolve_device
from ..layers.ssm import init_ssm_cache
from .cache_pool import CacheBackend
from .prefix_cache import RadixPrefixCache
from .programs import (
    clear_blocks_program,
    clear_ssm_slot_program,
    copy_blocks_program,
    invalidate_positions_paged_program,
    make_decode_step_paged,
    make_prefill_chunk_paged,
    make_verify_step_paged,
)


class BlockManager:
    """Free-list allocator with refcounts over `num_blocks` physical
    blocks. Block 0 is the reserved NULL block (never allocated; its pool
    `pos` stays -1, so table entries of 0 mean "nothing here").

    Refcount protocol: alloc() returns blocks at refcount 1 (the owning
    request). Sharing — a prefix-cache node adopting a block, or a fork
    duplicating a table — increfs. decref() frees at zero. A writer must
    hold the ONLY reference; `needs_cow` says whether a write has to
    copy first.
    """

    def __init__(self, num_blocks: int):
        assert num_blocks >= 2, "need at least the null block + one real"
        self.num_blocks = num_blocks
        self.ref = np.zeros((num_blocks,), np.int32)
        self.ref[0] = 1  # null block: pinned forever
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self.high_water = 0  # max blocks simultaneously allocated

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> List[int]:
        assert self.can_alloc(n), f"alloc({n}) with {len(self._free)} free"
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            assert self.ref[b] == 0
            self.ref[b] = 1
        self.high_water = max(self.high_water, self.num_used)
        return out

    def incref(self, block: int):
        assert block != 0 and self.ref[block] > 0
        self.ref[block] += 1

    def decref(self, block: int) -> bool:
        """Drop one reference; returns True if the block was freed."""
        assert block != 0 and self.ref[block] > 0, f"bad decref({block})"
        self.ref[block] -= 1
        if self.ref[block] == 0:
            self._free.append(block)
            return True
        return False

    def needs_cow(self, block: int) -> bool:
        return self.ref[block] > 1

    def fork_table(self, table: Sequence[int]) -> List[int]:
        """Share every block of a table with a second owner (copy-on-write
        fork): increfs each real block, returns the copied table."""
        out = list(table)
        for b in out:
            if b != 0:
                self.incref(b)
        return out


def init_paged_cache(cfg, num_blocks: int, block_size: int,
                     num_slots: int = 0, dtype=torch.bfloat16, *, device):
    """Per-layer cache list: attention layers get a (num_blocks,
    block_size, ...) block pool SHARED by all rows; SSM layers keep
    (num_slots, ...) per-row recurrent state (constant size: nothing to
    page), so an SSM arch needs ``num_slots`` >= 1."""
    device = resolve_device(device)
    if cfg.has_ssm() and num_slots < 1:
        raise ValueError(f"{cfg.name}: SSM layers need num_slots >= 1 rows")
    caches = []
    for _ in range(cfg.num_layers):
        c = {}
        if cfg.has_attention():
            c["attn"] = init_paged_kv_cache(cfg, num_blocks, block_size,
                                            dtype, device=device)
        if cfg.has_ssm():
            c["ssm"] = init_ssm_cache(cfg, num_slots, dtype, device=device)
        caches.append(c)
    return caches


class PagedBackend(CacheBackend):
    """Paged cache backend: block-table addressing + radix prefix cache.

    Admission needs a free slot (decode batch row and SSM state) AND
    enough free blocks for the uncached part of the prompt — NOT a whole
    max_len reservation. Decode allocates one block at a time as a row
    crosses block boundaries; when the free list runs dry the prefix cache
    evicts LRU-first, and if that is not enough the engine preempts the
    row (requeues it).

    ``cache_generated`` also publishes a retired request's generated
    tokens into the radix tree (``cache_finished``), so a multi-turn
    continuation gets prefix hits past its first prompt.
    """

    def __init__(self, cfg, num_slots: int, max_len: int,
                 dtype=torch.bfloat16, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = True, use_kernel: bool = True,
                 cache_generated: bool = False, telemetry: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_slots = num_slots
        self.max_len = max_len
        self.block_size = block_size
        self.blocks_per_row = -(-max_len // block_size)
        if num_blocks is None:
            # capacity parity with a contiguous pool by default; callers
            # size it down to get prompt-proportional memory
            num_blocks = num_slots * self.blocks_per_row + 1
        self.num_blocks = num_blocks
        self.cache = init_paged_cache(cfg, num_blocks, block_size,
                                      num_slots, dtype, device=self.device)
        self.mgr = BlockManager(num_blocks)
        # Prefix reuse splices cached KV under a new request, sound only
        # when all cross-token state lives in the blocks: recurrent SSM
        # state does not, so SSM and hybrid archs run paged but uncached.
        self.prefix: Optional[RadixPrefixCache] = (
            RadixPrefixCache(block_size)
            if prefix_cache and not cfg.has_ssm() else None
        )
        # Opt-in: the tree then keeps generation blocks until LRU
        # eviction, trading pool headroom for hits.
        self.cache_generated = cache_generated and self.prefix is not None
        self.tables = np.zeros((num_slots, self.blocks_per_row), np.int32)
        self._tables_dev = None  # rebuilt lazily when tables change
        self._free_slots: List[int] = list(range(num_slots - 1, -1, -1))
        # Peak blocks pinned by LIVE request tables (the request
        # footprint; tree-retained blocks are reclaimable cache).
        self.live_block_hw = 0
        self.use_kernel = use_kernel
        # With telemetry every program call stashes (phase, telemetry
        # tree) on `last_telemetry` for the engine to drain.
        self.telemetry = telemetry
        self.last_telemetry = None
        self._prefill_chunk = make_prefill_chunk_paged(cfg,
                                                       telemetry=telemetry)
        self._decode = make_decode_step_paged(cfg, use_kernel=use_kernel,
                                              telemetry=telemetry)
        self._verify = make_verify_step_paged(cfg, use_kernel=use_kernel,
                                              telemetry=telemetry)

    # -- CacheBackend ------------------------------------------------------

    @property
    def num_free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def max_chunk(self) -> int:
        # One chunk's positions are distinct, so distinct (block, offset)
        # slots — no scatter-order hazard at any chunk size.
        return self.max_len

    def accepts(self, prompt_len: int, max_new: int) -> bool:
        worst = -(-(prompt_len + max_new) // self.block_size)
        return worst <= self.num_blocks - 1

    def try_admit(self, req) -> Optional[Tuple[int, int]]:
        if not self._free_slots:
            return None
        prompt = req.prompt
        cached: List[int] = []
        if self.prefix is not None and not req.no_prefix_cache:
            cached = self.prefix.match(prompt)
        cached_len = len(cached) * self.block_size
        # blocks covering the uncached prompt tail plus the first decode
        # token, clamped at max_len (a prompt that fills the window
        # exactly retires before any decode write).
        n_logical = -(-min(len(prompt) + 1, self.max_len)
                      // self.block_size)
        need = n_logical - len(cached)
        # pin the matched chain before eviction can run
        for b in cached:
            self.mgr.incref(b)
        if not self._reserve(need):
            for b in cached:
                self.mgr.decref(b)
            return None
        fresh = self.mgr.alloc(need)
        self._invalidate_blocks(fresh)
        slot = self._free_slots.pop()
        clear_ssm_slot_program(self.cache, slot)
        row = self.tables[slot]
        row[:] = 0
        row[: len(cached)] = cached
        row[len(cached): n_logical] = fresh
        self._tables_dev = None
        self._touch_live_hw()
        if self.prefix is not None and not req.no_prefix_cache:
            self.prefix.record_lookup(len(cached))
        return slot, cached_len

    def prefill_chunk(self, params, buf, slot: int, toks, poss):
        dev = self.device
        table = torch.as_tensor(self.tables[slot: slot + 1], device=dev)
        out = self._prefill_chunk(
            params, self.cache, buf, slot, table,
            torch.as_tensor([toks], dtype=torch.long, device=dev),
            torch.as_tensor([poss], dtype=torch.int32, device=dev),
        )
        if self.telemetry:
            buf, self.last_telemetry = out[0], ("prefill", out[1])
            return buf
        return out

    def prefill_finished(self, entry):
        """Publish the request's full prompt blocks into the radix tree
        the moment prefill completes — later requests with the same
        system prompt share them immediately, not at retirement."""
        if self.prefix is None:
            return
        prompt = entry.req.prompt
        row = self.tables[entry.slot]
        n_full = len(prompt) // self.block_size
        self.prefix.insert(prompt[: n_full * self.block_size],
                           [int(b) for b in row[:n_full]], self.mgr)

    def ensure_decode_block(self, slot: int, pos: int) -> bool:
        """Make position `pos` writable for `slot`: allocate the logical
        block if the table has none (evicting prefix LRU under pressure),
        copy-on-write if it is shared. False = out of memory (preempt)."""
        return self._ensure_logical_block(slot, pos // self.block_size)

    def reserve_burst(self, slot: int, start: int, n: int) -> int:
        """Make positions [start, start+n) writable for a speculative
        burst: secure (alloc, or copy-on-write of a shared block) every
        logical block in range, in order, evicting prefix LRU under
        pressure. Returns the number of leading positions covered: a
        partial reservation shrinks the burst, and 0 means even the
        pending token's position could not be secured (preempt)."""
        bs = self.block_size
        end = min(start + n, self.max_len)
        covered = 0
        for lb in range(start // bs, -(-end // bs)):
            if not self._ensure_logical_block(slot, lb):
                break
            covered = min(end, (lb + 1) * bs) - start
        return max(0, min(covered, n))

    def rollback_burst(self, slot: int, next_pos: int):
        """Un-reserve blocks that exist only to hold rejected draft
        positions beyond ``next_pos`` (the row's next write position):
        afterwards the table and refcounts are the never-having-drafted
        state, blocks covering positions <= next_pos."""
        row = self.tables[slot]
        for lb in range(next_pos // self.block_size + 1,
                        self.blocks_per_row):
            blk = int(row[lb])
            if blk != 0:
                self.mgr.decref(blk)
                row[lb] = 0
                self._tables_dev = None

    def _ensure_logical_block(self, slot: int, lb: int) -> bool:
        blk = int(self.tables[slot, lb])
        if blk == 0:
            if not self._reserve(1):
                return False
            (fresh,) = self.mgr.alloc(1)
            self._invalidate_blocks([fresh])
            self.tables[slot, lb] = fresh
            self._tables_dev = None
            self._touch_live_hw()
        elif self.mgr.needs_cow(blk):
            if not self._reserve(1):
                return False
            (fresh,) = self.mgr.alloc(1)
            self.copy_blocks([blk], [fresh])
            self.mgr.decref(blk)
            self.tables[slot, lb] = fresh
            self._tables_dev = None
            self._touch_live_hw()  # divergence: one more unique block
        return True

    def _run(self, phase, *args):
        if self._tables_dev is None:
            self._tables_dev = torch.as_tensor(self.tables,
                                               device=self.device)
        program = self._decode if phase == "decode" else self._verify
        out = program(*args, self._tables_dev, self.cache)
        if self.telemetry:
            self.last_telemetry = (phase, out[1])
            return out[0]
        return out

    def decode(self, params, toks, pos):
        return self._run("decode", params, toks, pos)

    def verify(self, params, toks, poss):
        return self._run("verify", params, toks, poss)

    def invalidate_positions(self, positions):
        if self._tables_dev is None:
            self._tables_dev = torch.as_tensor(self.tables,
                                               device=self.device)
        invalidate_positions_paged_program(self.cache, positions,
                                           self._tables_dev)

    def cache_finished(self, entry):
        """Publish the retiring request's prompt+output chain into the
        radix tree (``cache_generated``): a repeat or multi-turn
        continuation then gets prefix hits past the original prompt
        boundary. Only full blocks are inserted, and the last emitted
        token is left out: it was sampled but never fed, so its K/V entry
        is unwritten."""
        if not self.cache_generated or entry.req.no_prefix_cache:
            return
        toks = list(entry.req.prompt) + list(entry.req.out[:-1])
        n_full = len(toks) // self.block_size
        if n_full == 0:
            return
        row = self.tables[entry.slot]
        self.prefix.insert(toks[: n_full * self.block_size],
                           [int(b) for b in row[:n_full]], self.mgr)

    def fork_slot(self, src_slot: int) -> Optional[int]:
        """Fork a live row into a fresh slot sharing ALL its blocks
        (copy-on-write): the clone diverges block by block as either row
        writes. Returns the new slot, or None when no slot is free. SSM
        rows are per slot, so they are copied by value."""
        if not self._free_slots:
            return None
        slot = self._free_slots.pop()
        self.tables[slot] = self.mgr.fork_table(self.tables[src_slot])
        self._tables_dev = None
        self._touch_live_hw()
        for layer in self.cache:
            for t in layer.get("ssm", {}).values():
                t[slot].copy_(t[src_slot])
        return slot

    def retire(self, slot: int):
        row = self.tables[slot]
        for b in row:
            if b != 0:
                self.mgr.decref(int(b))
        row[:] = 0
        self._tables_dev = None
        assert slot not in self._free_slots, f"double retire of slot {slot}"
        self._free_slots.append(slot)

    def token_capacity(self) -> int:
        return (self.num_blocks - 1) * self.block_size

    def tokens_free(self) -> int:
        """Token positions admission control can still promise: the free
        list plus tree-retained blocks no live table references (LRU
        eviction reclaims those)."""
        live = np.unique(self.tables[self.tables != 0]).size
        reclaimable = max(0, self.mgr.num_used - int(live))
        return (self.mgr.num_free + reclaimable) * self.block_size

    def occupancy(self) -> dict:
        live = int(np.unique(self.tables[self.tables != 0]).size)
        return {
            "blocks_free": self.mgr.num_free,
            "blocks_used": self.mgr.num_used,
            "blocks_live": live,
            "slots_free": len(self._free_slots),
            "slots_total": self.num_slots,
        }

    def bytes_per_block(self) -> int:
        return sum(t.numel() * t.element_size() // self.num_blocks
                   for layer in self.cache if "attn" in layer
                   for t in layer["attn"].values())

    def ssm_bytes(self) -> int:
        """Bytes of the SSM rows (every slot's conv ring and state)."""
        return sum(t.numel() * t.element_size()
                   for layer in self.cache if "ssm" in layer
                   for t in layer["ssm"].values())

    def peak_cache_bytes(self) -> int:
        """Peak live-request block footprint x bytes/block, plus the
        constant SSM rows: what a right-sized pool would have needed for
        the traffic. Tree-retained (evictable) blocks are excluded."""
        return self.live_block_hw * self.bytes_per_block() + self.ssm_bytes()

    def _touch_live_hw(self):
        # unique physical blocks: a prefix-shared block backing several
        # table rows is ONE resident block, not one per row
        used = self.tables[self.tables != 0]
        self.live_block_hw = max(self.live_block_hw,
                                 int(np.unique(used).size))

    # -- internals ---------------------------------------------------------

    def _reserve(self, n: int) -> bool:
        """Ensure `n` free blocks, evicting prefix-cache LRU leaves as
        needed; False if physically impossible right now."""
        while not self.mgr.can_alloc(n):
            if self.prefix is None or not self.prefix.evict_one(self.mgr):
                return False
        return True

    def _invalidate_blocks(self, blocks: List[int]):
        """pos -> -1 for freshly allocated blocks: stale entries from the
        previous owner must not alias the new request's positions."""
        if blocks:
            clear_blocks_program(self.cache, blocks)

    def copy_blocks(self, src: List[int], dst: List[int]):
        """Device copy src[i] -> dst[i] (copy-on-write)."""
        assert len(src) == len(dst)
        if src:
            copy_blocks_program(self.cache, src, dst)
