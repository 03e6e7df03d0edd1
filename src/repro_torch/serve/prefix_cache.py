"""Radix-tree prefix cache over paged KV blocks.

A copy of the JAX package's ``serve/prefix_cache.py`` (pure host code).

Maps token-id prefixes to chains of physical cache blocks so a request
whose prompt starts with an already-served prefix (the shared system
prompt case) skips prefill for the shared part: admission walks the tree,
pins the matched chain into the new request's block table, and prefill
starts at the first uncached token.

Structure and invariants (tested in tests/test_prefix_cache.py):

* One node per FULL block: the edge key is the block's exact
  ``block_size``-token id tuple. Partial blocks are never cached — a
  cached block is immutable prompt history, fully written, and is never
  written again by anyone (writers go through copy-on-write; the engine
  never targets positions inside a matched chain).
* Each node holds one reference on its physical block (BlockManager
  refcount). A matched request adds its own reference, so an in-use
  block's refcount is >= 2 and eviction (which only touches refcount-1
  blocks) can never free memory under a live request.
* ``match`` is capped at the prompt's last-but-one token: at least one
  prompt token always re-runs, because the engine needs the model's
  next-token logits for the final prompt position.
* Eviction is LRU over LEAVES only (a node's children always carry
  last_use >= their parent's from the same walk, so chains evict
  tail-first and the tree never dangles). ``last_use`` is a logical
  counter, not wall-clock — deterministic under test.
* Insertion dedups: if a node for the same token block already exists,
  the incumbent block is kept and the newcomer's duplicate is NOT
  adopted (it stays owned by its request alone and frees at retirement).

Eviction cost: candidate leaves live in a lazy min-heap keyed by the
logical clock, so ``evict_one`` is O(log n) amortized — it pops the true
LRU leaf without rescanning the tree (the seed implementation walked
every node per evicted block, O(tree) under memory pressure). The heap
is *lazy*: touching a node (match / insert dedup) pushes a fresh entry
rather than reordering, and stale entries — node evicted, no longer a
leaf, or carrying an outdated clock — are discarded when popped. Pinned
leaves (block refcount > 1: a live request or a fork also holds the
block) are re-pushed after the scan, since the tree is not told when the
BlockManager refcount drops back to 1; the pinned set is bounded by live
requests, so the amortized bound stands. Invariant: every evictable leaf
always has at least one heap entry carrying its current ``last_use``.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple


class _Node:
    __slots__ = ("key", "block", "children", "parent", "last_use")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_use = 0


class RadixPrefixCache:
    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = _Node((), 0, None)  # sentinel; never evicted
        self._clock = 0
        self.hits = 0  # blocks served from cache (stats for the bench)
        self.misses = 0  # lookups that matched nothing
        # Lazy LRU heap of (last_use, seq, node) eviction candidates; seq
        # breaks clock ties FIFO and keeps node comparison out of heapq.
        self._lru: List[Tuple[int, int, _Node]] = []
        self._seq = 0
        self._n_nodes = 0  # live tree nodes (cheap len for compaction)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _push_lru(self, node: "_Node"):
        """Register `node` as an eviction candidate at its current clock.
        Call whenever a node is a leaf and its last_use just changed (or
        it just became a leaf); earlier heap entries go stale and are
        skipped at pop time. When stale entries dominate (a long run of
        hits with no memory pressure pushes one per admission), the heap
        is rebuilt from the live leaves — O(tree), amortized away by the
        pushes that grew it."""
        if node is self.root or node.children:
            return
        self._seq += 1
        heapq.heappush(self._lru, (node.last_use, self._seq, node))
        if len(self._lru) > max(64, 4 * self._n_nodes):
            self._compact_lru()

    def _compact_lru(self):
        entries = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            for child in n.children.values():
                if child.children:
                    stack.append(child)
                else:
                    self._seq += 1
                    entries.append((child.last_use, self._seq, child))
        self._lru = entries
        heapq.heapify(self._lru)

    def __len__(self) -> int:
        n = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    # -- lookup ------------------------------------------------------------

    def match(self, tokens: List[int]) -> List[int]:
        """Longest cached chain of full blocks covering a strict prefix of
        ``tokens[:-1]`` (see module invariants). Returns the physical
        block ids in logical order and LRU-touches the path. The CALLER
        increfs the returned blocks (BlockManager) before using them, and
        calls ``record_lookup`` once the request actually admits — a
        queue-blocked request re-matches every admission attempt, and
        those retries must not inflate the hit stats."""
        bs = self.block_size
        limit = (len(tokens) - 1) // bs  # last token never cached-matched
        now = self._tick()
        node = self.root
        out: List[int] = []
        for i in range(limit):
            key = tuple(tokens[i * bs: (i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = now
            out.append(child.block)
            node = child
        # Only the deepest matched node can be a leaf (every other node on
        # the path has the next node as a child); refresh its LRU entry.
        self._push_lru(node)
        return out

    def record_lookup(self, n_blocks: int):
        """Account one ADMITTED request's match result: `n_blocks` blocks
        served from cache (0 = cold lookup)."""
        if n_blocks:
            self.hits += n_blocks
        else:
            self.misses += 1

    # -- insertion ---------------------------------------------------------

    def insert(self, tokens: List[int], blocks: List[int], mgr) -> int:
        """Register a fully-prefilled chain: tokens must be a whole number
        of blocks and ``blocks[i]`` the physical block holding block i's
        KV. New nodes take one reference on their block via ``mgr``;
        existing nodes keep their incumbent block (dedup). Returns the
        number of newly adopted blocks."""
        bs = self.block_size
        assert len(tokens) == len(blocks) * bs, "insert wants full blocks"
        now = self._tick()
        node = self.root
        adopted = 0
        for i, block in enumerate(blocks):
            key = tuple(tokens[i * bs: (i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                mgr.incref(block)
                child = _Node(key, block, node)
                node.children[key] = child
                adopted += 1
                self._n_nodes += 1
            child.last_use = now
            node = child
        # The chain tail is the only possible leaf of this walk; nodes
        # that just gained a child leave stale heap entries behind, which
        # evict_one discards on pop.
        self._push_lru(node)
        return adopted

    # -- eviction ----------------------------------------------------------

    def evict_one(self, mgr) -> bool:
        """Drop the least-recently-used UNREFERENCED leaf (block refcount
        1 means only the tree holds it) and release its block. Returns
        False when nothing is evictable — every cached block is pinned by
        a live request.

        O(log n) amortized: pops the lazy LRU heap instead of rescanning
        the tree. Stale entries (node evicted, grew children, or touched
        since push) are discarded; pinned leaves are set aside and
        re-pushed — refcounts change outside the tree's sight, so their
        entries must survive until the pin drops."""
        pinned: List[Tuple[int, int, _Node]] = []
        victim: Optional[_Node] = None
        while self._lru:
            lu, seq, node = heapq.heappop(self._lru)
            parent = node.parent
            if (parent is None or parent.children.get(node.key) is not node
                    or node.children or lu != node.last_use):
                continue  # stale — a fresher entry (or none) supersedes it
            if mgr.ref[node.block] != 1:
                pinned.append((lu, seq, node))
                continue
            victim = node
            break
        for entry in pinned:
            heapq.heappush(self._lru, entry)
        if victim is None:
            return False
        parent = victim.parent
        del parent.children[victim.key]
        victim.parent = None  # mark detached for any remaining heap entry
        self._n_nodes -= 1
        mgr.decref(victim.block)
        if not parent.children:
            # chain tail removed: the parent is the next LRU candidate
            self._push_lru(parent)
        return True

    def evict_all_unreferenced(self, mgr) -> int:
        """Flush every evictable node (shutdown / tests)."""
        n = 0
        while self.evict_one(mgr):
            n += 1
        return n
