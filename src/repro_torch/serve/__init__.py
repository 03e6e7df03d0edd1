"""Serving subsystem of the port: continuous batching over the paged
cache backend.

  cache_pool    — CacheBackend interface
  block_manager — paged backend: KV token blocks, refcounts/COW, tables
  prefix_cache  — radix tree mapping token prefixes to shared block chains
  programs      — the eager device programs of the paged backend
  sampling      — batched per-request sampler (greedy/temp/top-k/top-p)
  scheduler     — host-side admission queue + slot state machine
  engine        — ServeEngine
  telemetry     — host-side flattening of the model-interior telemetry
"""
from .block_manager import BlockManager, PagedBackend  # noqa: F401
from .engine import ServeEngine  # noqa: F401
from .prefix_cache import RadixPrefixCache  # noqa: F401
from .sampling import GREEDY, SamplingParams  # noqa: F401
from .scheduler import QueueFull, Request, Scheduler  # noqa: F401
