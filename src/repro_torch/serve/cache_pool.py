"""Serving-memory backend interface, counterpart of the ``CacheBackend``
part of ``repro/serve/cache_pool.py``.

The port has one implementation so far, ``PagedBackend``
(serve/block_manager.py). The contiguous slot-row backend and the
speculative-decoding hooks (verify, burst reservation and rollback) wait
for later slices.
"""
from __future__ import annotations


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

    def retire(self, slot: int):
        """Release every resource `slot` holds."""
        raise NotImplementedError

    def peak_cache_bytes(self) -> int:
        """High-water cache memory this backend actually needed."""
        raise NotImplementedError
