"""Serving subsystem of the port: continuous batching over the contiguous
or the paged cache backend.

  cache_pool    — slot-row CachePool, ContiguousBackend, CacheBackend
  block_manager — paged backend: KV token blocks, refcounts/COW, tables
  prefix_cache  — radix tree mapping token prefixes to shared block chains
  programs      — the eager device programs of both backends
  sampling      — batched per-request sampler (greedy/temp/top-k/top-p)
  scheduler     — host-side admission queue + slot state machine
  engine        — ServeEngine
  telemetry     — model-interior telemetry consumers: flattening, the
                  engine's aggregator and the batch-variance probe
"""
from .block_manager import (  # noqa: F401
    BlockManager,
    PagedBackend,
    init_paged_cache,
)
from .cache_pool import (  # noqa: F401
    CacheBackend,
    CachePool,
    ContiguousBackend,
    clear_slot,
    pool_row,
    pool_write_row,
)
from .engine import ServeEngine  # noqa: F401
from .prefix_cache import RadixPrefixCache  # noqa: F401
from .programs import (  # noqa: F401
    make_decode_step,
    make_decode_step_paged,
    make_prefill_chunk_paged,
    make_prefill_chunk_step,
    make_prefill_step,
)
from .sampling import GREEDY, SamplingParams  # noqa: F401
from .scheduler import QueueFull, Request, Scheduler  # noqa: F401
from .telemetry import (  # noqa: F401
    TelemetryAggregator,
    batch_variance_probe,
    flatten_telemetry,
    telemetry_rows,
)
