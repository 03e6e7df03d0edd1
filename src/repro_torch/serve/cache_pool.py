"""Slot-row cache pool and the serving-memory backend interface,
counterpart of ``repro/serve/cache_pool.py``.

The pool owns ONE cache of fixed shape (``num_slots`` rows x
``max_len`` positions a layer, ``models.init_cache``) for the engine's
lifetime; a request borrows a row ("slot") while it is resident and
returns it the tick it finishes. Attention rings store per-row
positions, so admitting or retiring one row never touches another.

* A freshly acquired slot is CLEAN: every attention ``pos`` entry of the
  row is -1 (stale K/V values stay, unreachable: the mask admits only
  pos >= 0, and a write replaces value and pos together), and its SSM
  conv and state rows are zero (recurrent state has no position mask).
* The pool never reallocates: the programs update its tensors in place
  (the JAX package replaces them functionally and donates the old
  buffers).

Two backends implement ``CacheBackend``: ``ContiguousBackend`` below
(one ``max_len`` row per slot; the engine's default, as in the
reference) and ``PagedBackend`` (``serve/block_manager.py``). Both
serve speculative decoding (``serve/spec_decode.py``): a (B, k+1) verify
step and the scrub of rejected lanes; the contiguous pool reserves
``max_len`` a row up front, so burst reservation and rollback are
no-ops here.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..layers.attention import reset_kv_rows
from ..layers.common import resolve_device
from ..layers.ssm import reset_ssm_rows
from ..models import init_cache

def clear_slot(cache, slot: int):
    """Invalidate row ``slot`` of every layer in place: attention pos ->
    -1, SSM rows zeroed."""
    for layer in cache:
        if "attn" in layer:
            reset_kv_rows(layer["attn"], slot)
        if "ssm" in layer:
            reset_ssm_rows(layer["ssm"], slot)
    return cache


def pool_row(cache, slot: int):
    """Row ``slot`` of every leaf as a batch-1 view: the model runs a
    chunked prefill on it, and its in-place writes land in the pool."""
    return [{k: {n: t[slot:slot + 1] for n, t in v.items()}
             for k, v in layer.items()} for layer in cache]


def pool_write_row(cache, slot: int, row):
    """Copy a batch-1 row (``pool_row``'s structure) into the pool at
    ``slot``, in place; returns the pool."""
    for layer, rl in zip(cache, row):
        for k, v in layer.items():
            for n, t in v.items():
                t[slot:slot + 1].copy_(rl[k][n])
    return cache


class CachePool:
    """Free-list slot allocator over one fixed-shape cache on ``device``.

    Slot lifecycle: free -> acquire() [row cleared] -> in use by exactly
    one request -> release() -> free. Allocation is LIFO, so the hottest
    slot is reused first."""

    def __init__(self, cfg, num_slots: int, max_len: int,
                 dtype=torch.bfloat16, *, device):
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.cache = init_cache(cfg, num_slots, max_len, dtype,
                                device=self.device)
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        # Smallest ring: a prefill chunk must fit in it, so that one
        # chunk's positions never share a slot.
        self.min_ring_len = min(
            (layer["attn"]["pos"].shape[-1] for layer in self.cache
             if "attn" in layer),
            default=max_len,
        )

    @property
    def num_free(self) -> int:
        return len(self._free)

    def acquire(self) -> Optional[int]:
        """Pop a free slot and clear its row; None if exhausted."""
        if not self._free:
            return None
        slot = self._free.pop()
        clear_slot(self.cache, slot)
        return slot

    def release(self, slot: int):
        """Return a slot to the free list (the row is cleared at its next
        acquire)."""
        assert slot not in self._free, f"double release of slot {slot}"
        self._free.append(slot)


# ---------------------------------------------------------------------------
# Cache backends: the interface ServeEngine drives
# ---------------------------------------------------------------------------


class CacheBackend:
    """The methods ``ServeEngine`` calls on its memory backend."""

    num_free_slots: int
    max_chunk: int
    # model-interior telemetry: a backend built with telemetry=True stashes
    # the latest (phase, telemetry tree) here after every prefill and
    # decode call; the engine drains it
    telemetry: bool = False
    last_telemetry = None

    def accepts(self, prompt_len: int, max_new: int) -> bool:
        """Can this request EVER fit (submit-time validation)?"""
        raise NotImplementedError

    def try_admit(self, req):
        """Admit `req` if memory allows: returns (slot, cached_len) —
        cached_len > 0 when a prefix-cache hit lets prefill skip the
        first tokens — or None to leave it queued."""
        raise NotImplementedError

    def prefill_chunk(self, params, buf, slot: int, toks, poss):
        """Run one prompt chunk for `slot`; returns the updated logits
        buffer (cache updates stay inside the backend)."""
        raise NotImplementedError

    def prefill_finished(self, entry):
        """Hook fired when a request's last prompt chunk has run."""

    def ensure_decode_block(self, slot: int, pos: int) -> bool:
        """Guarantee position `pos` of `slot` is writable before a decode
        step; False means out of memory (the engine preempts the row)."""
        return True

    def decode(self, params, toks, pos):
        """One batched decode step over all slots; returns logits."""
        raise NotImplementedError

    # -- speculative decoding (serve/spec_decode.py) -----------------------

    def verify(self, params, toks, poss):
        """One batched multi-token verify step: toks/poss are (B, k+1)
        with lane 0 = each row's pending token; returns (B, k+1, V)
        logits. Lanes with position -1 write nothing."""
        raise NotImplementedError

    def reserve_burst(self, slot: int, start: int, n: int) -> int:
        """Make positions [start, start+n) of `slot` writable for a
        speculative burst; returns how many leading positions are covered
        (0 = out of memory even for the pending token: preempt). The
        contiguous pool reserves max_len rows up front, so every
        in-range position is always writable."""
        return n

    def rollback_burst(self, slot: int, next_pos: int):
        """Undo burst-only reservations after acceptance: release memory
        that exists purely to hold positions > `next_pos` (the row's next
        write position). No-op on the contiguous pool."""

    def invalidate_positions(self, positions):
        """pos -> -1 for a (B, k+1) batch of absolute positions (-1 lanes
        drop): scrubs rejected draft lanes so the cache state equals
        never having drafted."""
        raise NotImplementedError

    def cache_finished(self, entry):
        """Hook fired at normal retirement (not preemption), before the
        slot is released: the paged backend publishes generated-token
        blocks into the radix tree here when ``cache_generated`` is on."""

    def retire(self, slot: int):
        """Release every resource `slot` holds."""
        raise NotImplementedError

    def token_capacity(self) -> int:
        """Total token positions the pool can ever hold (the denominator
        of the server's load-shedding budget)."""
        raise NotImplementedError

    def tokens_free(self) -> int:
        """Token positions not currently promised to live work (reclaimable
        prefix-cache blocks included on the paged backend)."""
        raise NotImplementedError

    def peak_cache_bytes(self) -> int:
        """High-water cache memory this backend actually needed."""
        raise NotImplementedError

    def occupancy(self) -> dict:
        """Host-side memory occupancy for the flight recorder (one dict a
        tick: cheap, and no device read)."""
        return {}


class ContiguousBackend(CacheBackend):
    """``CachePool`` behind the ``CacheBackend`` interface: admission is a
    free slot, memory is num_slots x max_len whatever the traffic.
    Attention gathers the ring, as in the reference: no kernel runs on
    this backend. ``telemetry=True`` stashes each call's ``(phase,
    telemetry tree)`` on ``last_telemetry``; the returned logits are the
    same."""

    def __init__(self, cfg, num_slots: int, max_len: int,
                 dtype=torch.bfloat16, telemetry: bool = False,
                 device="cuda"):
        from .programs import (
            invalidate_positions_program,
            make_decode_step,
            make_prefill_chunk_step,
            make_verify_step,
        )

        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.telemetry = telemetry
        self.last_telemetry = None
        self.pool = CachePool(cfg, num_slots, max_len, dtype, device=device)
        self.device = self.pool.device
        self._prefill_chunk = make_prefill_chunk_step(cfg,
                                                      telemetry=telemetry)
        self._decode = make_decode_step(cfg, telemetry=telemetry)
        self._verify = make_verify_step(cfg, telemetry=telemetry)
        self._invalidate = invalidate_positions_program

    @property
    def num_free_slots(self) -> int:
        return self.pool.num_free

    @property
    def max_chunk(self) -> int:
        return self.pool.min_ring_len

    def accepts(self, prompt_len: int, max_new: int) -> bool:
        return prompt_len + max_new <= self.max_len

    def try_admit(self, req):
        slot = self.pool.acquire()
        return None if slot is None else (slot, 0)

    def prefill_chunk(self, params, buf, slot, toks, poss):
        dev = self.device
        out = self._prefill_chunk(
            params, self.pool.cache, buf, slot,
            torch.as_tensor([toks], dtype=torch.long, device=dev),
            torch.as_tensor([poss], dtype=torch.int32, device=dev),
        )
        if self.telemetry:
            buf, self.last_telemetry = out[0], ("prefill", out[1])
            return buf
        return out

    def decode(self, params, toks, pos):
        out = self._decode(params, toks, pos, self.pool.cache)
        if self.telemetry:
            self.last_telemetry = ("decode", out[1])
            return out[0]
        return out

    def verify(self, params, toks, poss):
        out = self._verify(params, toks, poss, self.pool.cache)
        if self.telemetry:
            self.last_telemetry = ("verify", out[1])
            return out[0]
        return out

    def invalidate_positions(self, positions):
        self._invalidate(self.pool.cache, positions)

    def retire(self, slot: int):
        self.pool.release(slot)

    def token_capacity(self) -> int:
        return self.num_slots * self.max_len

    def tokens_free(self) -> int:
        return self.pool.num_free * self.max_len

    def peak_cache_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for layer in self.pool.cache
                   for v in layer.values() for t in v.values())

    def occupancy(self) -> dict:
        return {"slots_free": self.pool.num_free,
                "slots_total": self.num_slots}
