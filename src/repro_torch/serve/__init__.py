"""Serving subsystem of the port: continuous batching over the contiguous
or the paged cache backend.

  cache_pool    — slot-row CachePool, ContiguousBackend, CacheBackend
  block_manager — paged backend: KV token blocks, refcounts/COW, tables
  prefix_cache  — radix tree mapping token prefixes to shared block chains
  programs      — the eager device programs of both backends
  sampling      — batched per-request sampler (greedy/temp/top-k/top-p)
                  and the speculative accept step
  scheduler     — host-side admission queue + slot state machine
  spec_decode   — speculative decoding: n-gram self-drafting, (B, k+1)
                  verify, exact-match accept with exact rollback
  engine        — ServeEngine (continuous) / WaveEngine (lockstep baseline)
  server        — AsyncServer: asyncio front end (deadlines, cancellation,
                  load shedding, retry with backoff, token streaming)
  metrics       — ServeMetrics counters/histograms + stuck-step Watchdog
  tracing       — per-request span timelines + engine tick flight recorder
  exporter      — Prometheus text-format rendering (/metrics) + strict parser
  telemetry     — model-interior telemetry consumers: flattening, the
                  engine's aggregator and the batch-variance probe
  faults        — seeded fault injection + the chaos harness
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
from .engine import ServeEngine, WaveEngine  # noqa: F401
from .exporter import (  # noqa: F401
    parse_prometheus,
    render_prometheus,
)
from .faults import (  # noqa: F401
    FaultInjector,
    FlakyDrafter,
    GarbageDrafter,
    KernelFailure,
    assert_leak_free,
    pool_snapshot,
    run_chaos,
)
from .metrics import (  # noqa: F401
    Histogram,
    ServeMetrics,
    Watchdog,
    collect_engine_metrics,
)
from .prefix_cache import RadixPrefixCache  # noqa: F401
from .programs import (  # noqa: F401
    make_decode_step,
    make_decode_step_paged,
    make_prefill_chunk_paged,
    make_prefill_chunk_step,
    make_prefill_step,
)
from .sampling import (  # noqa: F401
    GREEDY,
    SamplingParams,
    sample_tokens,
    spec_accept_tokens,
)
from .scheduler import (  # noqa: F401
    QueueFull,
    Request,
    Scheduler,
    SlotEntry,
)
from .server import (  # noqa: F401
    AsyncServer,
    ServerConfig,
    ShedError,
)
from .spec_decode import (  # noqa: F401
    Drafter,
    NgramDrafter,
    SpecConfig,
    SpecDecoder,
)
from .telemetry import (  # noqa: F401
    TelemetryAggregator,
    batch_variance_probe,
    flatten_telemetry,
    telemetry_rows,
)
from .tracing import (  # noqa: F401
    FlightRecorder,
    ProgramTimer,
    Tracer,
    render_timeline,
    timeline,
    validate_timeline,
)
