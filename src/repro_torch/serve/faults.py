"""Deterministic fault injection and the chaos harness for the serving
stack, counterpart of ``repro/serve/faults.py``.

Every fault is seeded and counter-indexed, so a chaos run is a pure
function of its seed and a failure reproduces exactly. The injector
reaches into nothing beyond the public backend surface: it shadows the
backend's bound ``decode``/``verify`` with wrappers on the *instance*
(the class stays untouched), which is where a real fault would land.

Fault classes, each ending in a defined terminal state:

* ``poison_logits``      — NaN logits for one slot at model call k
                           -> that row retires, finish_reason="error".
* ``inject_kernel_failure`` — the paged kernel engine's k-th decode /
                           verify call raises ``KernelFailure``
                           -> the error surfaces from ``engine.step()``,
                           the call's rows retire with
                           finish_reason="error", serving continues on
                           the kernel (the reference falls back to the
                           gather path instead).
* ``hold_blocks``        — pool exhaustion: the injector allocates (and
                           later releases) blocks or slots
                           -> admission stalls / live rows preempt.
* ``latency_spike``      — the next n model calls sleep
                           -> deadline misses, watchdog exercise.
* ``GarbageDrafter`` / ``FlakyDrafter`` — a speculative drafter producing
                           out-of-range junk / raising
                           -> per-row draft disable, output unchanged.
* cancellation storms    — run_chaos cancels random live/queued
                           requests -> finish_reason="cancelled", all
                           resources free within the tick.

``pool_snapshot`` / ``assert_leak_free`` are the invariant checkers:
after every request reaches a terminal state, the backend holds ZERO
per-request resources (block pool, refcounts, tables, slots equal to a
fresh engine's).

Run standalone (reduced config, the CPU's plain path)::

    PYTHONPATH=src python -m repro_torch.serve.faults --device cpu --seed 0
"""
from __future__ import annotations

import random
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .scheduler import QueueFull, Request


# ---------------------------------------------------------------------------
# Drafters that misbehave (speculative-decoding fault surface)
# ---------------------------------------------------------------------------


class GarbageDrafter:
    """Seeded drafter proposing uniform-random token ids, half of them
    OUT of vocab range: exercises draft validation (out-of-range tokens
    must be truncated, never verified) and the zero-acceptance per-row
    disable. Never changes served tokens — garbage drafts just reject."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.rng = random.Random(seed)

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        return [self.rng.randrange(2 * self.vocab_size) for _ in range(k)]


class FlakyDrafter:
    """Drafter that raises on every ``propose`` after the first
    ``ok_calls``: exercises the drafter-exception path (errors counted,
    row's draft lane disabled after ``max_drafter_errors``, serving
    continues non-speculatively for that row)."""

    def __init__(self, ok_calls: int = 0):
        self.ok_calls = ok_calls
        self.calls = 0

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        self.calls += 1
        if self.calls > self.ok_calls:
            raise RuntimeError("injected drafter failure")
        return []


# ---------------------------------------------------------------------------
# Fault injector
# ---------------------------------------------------------------------------


class KernelFailure(RuntimeError):
    """The injected failure of a kernel to build or launch."""


class FaultInjector:
    """Attach seeded faults to one engine's backend.

    ``model_calls`` counts decode+verify model calls since attach; all
    scheduled faults key off it, so timing is deterministic under any
    request interleaving. ``detach()`` restores the pristine backend
    (held blocks must be released first)."""

    def __init__(self, engine, seed: int = 0):
        self.eng = engine
        self.backend = engine.backend
        self.rng = random.Random(seed)
        self.model_calls = 0
        self.nan_injected = 0
        self.kernel_failures = 0
        self.latency_injected = 0
        self._poison: Dict[int, List[int]] = {}  # call index -> slots
        self._latency: Dict[int, float] = {}  # call index -> sleep s
        self._kernel_fail: set = set()  # call indices that raise
        self._held: List[int] = []  # paged blocks we pinned
        self._held_slots: List[int] = []  # contiguous slots we pinned
        self._orig_decode = self.backend.decode
        self._orig_verify = self.backend.verify
        self.backend.decode = self._wrapped(self._orig_decode)
        self.backend.verify = self._wrapped(self._orig_verify)

    def _wrapped(self, orig):
        def call(params, toks, pos):
            self.model_calls += 1
            if self.model_calls in self._kernel_fail:
                self._kernel_fail.discard(self.model_calls)
                self.kernel_failures += 1
                raise KernelFailure("injected kernel failure")
            sleep_s = self._latency.pop(self.model_calls, 0.0)
            if sleep_s > 0.0:
                self.latency_injected += 1
                time.sleep(sleep_s)
            logits = orig(params, toks, pos)
            slots = self._poison.pop(self.model_calls, ())
            if slots:
                # Poison the slot's whole logits row ((B, L, V) for both
                # decode and verify), as a diverged model would, in a copy:
                # no buffer the backend keeps is touched. The engine's
                # finite-rows guard must retire exactly this row.
                logits = logits.clone()
                for slot in slots:
                    logits[slot] = float("nan")
                    self.nan_injected += 1
            return logits

        return call

    def detach(self):
        """Remove the wrappers and release anything still held."""
        self.release_blocks()
        self.backend.decode = self._orig_decode
        self.backend.verify = self._orig_verify

    # -- fault scheduling --------------------------------------------------

    def poison_logits(self, slot: int, after_calls: int = 1):
        """NaN the logits of `slot` on the after_calls-th model call
        from now (decode or verify, whichever lands there)."""
        assert after_calls >= 1
        self._poison.setdefault(self.model_calls + after_calls, []
                                ).append(slot)

    def latency_spike(self, sleep_s: float, after_calls: int = 1):
        """Make the after_calls-th model call from now take `sleep_s`
        longer (deadline/watchdog pressure)."""
        assert after_calls >= 1
        self._latency[self.model_calls + after_calls] = float(sleep_s)

    def inject_kernel_failure(self, after_calls: int = 1):
        """Make the after_calls-th decode/verify call from now raise
        ``KernelFailure`` before it runs, as a kernel that fails to build
        or launch would: the error must surface from ``engine.step()``,
        the call's rows retire with finish_reason="error" and free their
        memory, and the engine keeps serving on the kernel.
        ``kernel_failures`` counts the failures raised."""
        assert after_calls >= 1
        assert getattr(self.backend, "use_kernel", False), (
            "paged kernel engine only")
        self._kernel_fail.add(self.model_calls + after_calls)

    def hold_blocks(self, n: Optional[int] = None) -> int:
        """Pool exhaustion: pin `n` free resources (all of them if
        None). Paged: physical blocks via the BlockManager. Contiguous:
        whole slots. Returns how many were actually pinned."""
        be = self.backend
        if hasattr(be, "mgr"):
            free = be.mgr.num_free
            n = free if n is None else min(n, free)
            if n:
                self._held += be.mgr.alloc(n)
            return n
        free = be.pool.num_free
        n = free if n is None else min(n, free)
        for _ in range(n):
            self._held_slots.append(be.pool.acquire())
        return n

    def release_blocks(self):
        """Undo ``hold_blocks`` (refcounts return to pre-fault state)."""
        be = self.backend
        for b in self._held:
            be.mgr.decref(b)
        self._held = []
        for s in self._held_slots:
            be.pool.release(s)
        self._held_slots = []


# ---------------------------------------------------------------------------
# Pool-state invariants
# ---------------------------------------------------------------------------


def pool_snapshot(engine) -> dict:
    """Host-side resource state: everything that must return to its
    fresh-engine value once all work reaches a terminal state."""
    be = engine.backend
    snap = {
        "live_slots": sorted(engine.sched.live.keys()),
        "queued": len(engine.sched.queue),
    }
    if hasattr(be, "mgr"):
        snap.update(
            free_blocks=sorted(be.mgr._free),
            refcounts=be.mgr.ref.tolist(),
            tables=be.tables.copy(),
            free_slots=sorted(be._free_slots),
        )
    else:
        snap["free_slots"] = sorted(be.pool._free)
    if engine._spec is not None:
        snap["spec_pending"] = engine._spec._pending.tolist()
    return snap


def assert_leak_free(engine, flush_prefix_cache: bool = True):
    """Every request reached a terminal state => the engine holds zero
    per-request resources. With ``flush_prefix_cache`` the radix tree is
    evicted first, so the check is exact pool parity with a FRESH
    engine: all blocks free, every refcount zero (null block aside),
    all tables null, no pending speculative state. Without flushing,
    tree-retained blocks are legitimate — each must then be owned by
    exactly the tree (refcount 1)."""
    assert not engine.sched.live, f"live rows leak: {engine.sched.live}"
    assert not engine.sched.queue, "queued requests remain"
    be = engine.backend
    if engine._spec is not None:
        pend = engine._spec._pending
        assert (pend < 0).all(), f"pending spec state leaks: {pend}"
    if not hasattr(be, "mgr"):  # contiguous
        free = sorted(be.pool._free)
        assert free == list(range(be.num_slots)), f"slot leak: {free}"
        return
    assert (be.tables == 0).all(), "block-table entries survive retirement"
    if flush_prefix_cache and be.prefix is not None:
        be.prefix.evict_all_unreferenced(be.mgr)
    if flush_prefix_cache or be.prefix is None:
        assert be.mgr.num_used == 0, (
            f"{be.mgr.num_used} blocks leak (refs "
            f"{np.flatnonzero(be.mgr.ref[1:]) + 1})"
        )
        assert (be.mgr.ref[1:] == 0).all(), "refcount leak"
        assert sorted(be.mgr._free) == list(range(1, be.mgr.num_blocks))
    else:
        # Tree-retained blocks: exactly one owner each (the tree).
        held = np.flatnonzero(be.mgr.ref[1:]) + 1
        assert (be.mgr.ref[held] == 1).all(), (
            f"non-tree refcounts leak: {be.mgr.ref[held]}"
        )


# ---------------------------------------------------------------------------
# Chaos runner
# ---------------------------------------------------------------------------

_TERMINAL = {"eos", "length", "cache_ceiling", "cancelled", "deadline",
             "shed", "error"}


def run_chaos(engine, n_requests: int = 24, seed: int = 0,
              max_steps: int = 3000,
              p_cancel: float = 0.15, p_poison: float = 0.1,
              p_deadline: float = 0.15, p_exhaust: float = 0.05,
              p_latency: float = 0.05,
              kernel_failure: bool = False) -> dict:
    """Drive `engine` through a seeded storm of admissions, client
    cancellations, tiny deadlines, NaN poisonings, pool exhaustion and
    latency spikes, then assert every request landed in a defined
    terminal state and the pool is leak-free. Returns a counter dict.

    Deterministic given (seed, engine config): every decision comes
    from one ``random.Random(seed)``, every fault is counter-indexed.
    ``kernel_failure`` (a paged kernel engine) makes the first model call
    raise ``KernelFailure``: the run checks that it surfaced from one
    tick, once, and goes on stepping.
    """
    rng = random.Random(seed)
    inj = FaultInjector(engine, seed=seed + 1)
    vocab = engine.cfg.vocab_size
    reqs = [
        Request(
            prompt=[rng.randrange(1, vocab) for _ in
                    range(rng.randrange(2, 9))],
            max_new_tokens=rng.randrange(2, 7),
            # Tiny total deadline on a subset: some of these MUST miss.
            deadline_s=(0.0 if rng.random() < p_deadline else None),
        )
        for _ in range(n_requests)
    ]
    pending = list(reqs)
    stats = {"cancel_storms": 0, "exhaustions": 0}
    injected = kernel_failure and getattr(engine.backend, "use_kernel",
                                          False)
    if injected:
        inj.inject_kernel_failure()

    def tick():
        try:
            engine.step()
        except KernelFailure:
            stats["kernel_failures_surfaced"] = (
                stats.get("kernel_failures_surfaced", 0) + 1)

    steps = 0
    while (pending or engine.sched.pending()) and steps < max_steps:
        steps += 1
        # Bursty arrivals: 0-3 submissions per tick. A bounded-queue
        # reject is itself a chaos outcome: the request sheds.
        for _ in range(rng.randrange(0, 4)):
            if pending:
                req = pending.pop()
                try:
                    engine.submit(req)
                except QueueFull:
                    req.done = True
                    req.finish_reason = "shed"
                    stats["sheds"] = stats.get("sheds", 0) + 1
                    tracer = getattr(engine, "tracer", None)
                    if tracer is not None:
                        tracer.shed(req)
        if rng.random() < p_cancel:
            victims = ([e.req for e in engine.sched.live.values()]
                       + list(engine.sched.queue))
            if victims:
                engine.cancel(rng.choice(victims))
                stats["cancel_storms"] += 1
        if rng.random() < p_poison and engine.sched.live:
            inj.poison_logits(rng.choice(list(engine.sched.live)))
        if rng.random() < p_latency:
            inj.latency_spike(0.001)
        if rng.random() < p_exhaust and not inj._held:
            if inj.hold_blocks():
                stats["exhaustions"] += 1
        elif inj._held and rng.random() < 0.5:
            inj.release_blocks()
        tick()
    inj.release_blocks()
    # A poison scheduled for a call that never happened is not a leak.
    while engine.sched.pending() and steps < 2 * max_steps:
        tick()
        steps += 1
    assert not engine.sched.pending(), "chaos run failed to drain"
    assert inj.kernel_failures == int(injected), (
        "the injected kernel failure never fired")
    assert stats.get("kernel_failures_surfaced", 0) == inj.kernel_failures, (
        "an injected kernel failure did not surface from the tick")
    for r in reqs:
        assert r.done, "request stranded without a terminal state"
        assert r.finish_reason in _TERMINAL, (
            f"undefined terminal state {r.finish_reason!r}"
        )
    # Observability contract (engines built with trace/flight_recorder):
    # every terminal request's span timeline must be internally
    # consistent with its finish_reason, the tick recorder must actually
    # have recorded, and a forced stall must produce a post-mortem dump.
    tracer = getattr(engine, "tracer", None)
    if tracer is not None:
        from .tracing import validate_timeline
        for r in reqs:
            validate_timeline(r)
        stats["trace_spans"] = tracer.spans_recorded
        stats["timelines_valid"] = len(reqs)
    recorder = getattr(engine, "recorder", None)
    if recorder is not None:
        assert recorder.ticks > 0 and recorder.records(), (
            "flight recorder empty after a chaos run"
        )
        _force_stall_dump(engine, inj)
        assert recorder.dumps >= 1, "forced stall produced no dump"
        assert recorder.last_dump["records"], "stall dump carries no ticks"
        stats["flight_ticks"] = recorder.ticks
        stats["stall_dumps"] = recorder.dumps
    inj.detach()
    assert_leak_free(engine)
    from collections import Counter
    reasons = Counter(r.finish_reason for r in reqs)
    out = dict(stats, steps=steps, nan_injected=inj.nan_injected,
               kernel_failures=inj.kernel_failures,
               **{f"finish_{k}": v for k, v in sorted(reasons.items())})
    out.update(engine.robustness_stats())
    return out


def _force_stall_dump(engine, inj: FaultInjector, stall_s: float = 0.02,
                      timeout_s: float = 10.0):
    """Post-chaos stall exercise: pin the whole pool, submit a probe
    request that therefore cannot admit, and spin the tick loop under a
    fast Watchdog whose on_stall dumps the flight recorder — the
    post-mortem path the server wires up, driven synchronously. The
    probe then completes normally once the pool is released (its
    timeline must validate like any other request's)."""
    from .metrics import Watchdog
    recorder = engine.recorder
    wd = Watchdog(
        stall_s=stall_s,
        on_stall=lambda s: recorder.dump("watchdog_stall"),
    )
    probe = Request(prompt=[1, 2, 3], max_new_tokens=2)
    inj.hold_blocks()
    engine.submit(probe)
    deadline = time.perf_counter() + timeout_s
    while wd.stalls == 0 and time.perf_counter() < deadline:
        emitted = engine.step()
        wd.beat(emitted > 0, engine.sched.pending())
    assert wd.stalls >= 1, "stall never fired with the pool pinned"
    inj.release_blocks()
    while engine.sched.pending():
        engine.step()
    assert probe.done and probe.finish_reason in _TERMINAL
    tracer = getattr(engine, "tracer", None)
    if tracer is not None:
        from .tracing import validate_timeline
        validate_timeline(probe)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _main(argv=None):
    import argparse

    import torch

    from ..configs import get_config, reduced
    from ..models import lm_init
    from .engine import ServeEngine
    from .spec_decode import SpecConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--config", default="llama3-8b")
    ap.add_argument("--backend", default="paged",
                    choices=["contiguous", "paged"])
    ap.add_argument("--device", default="cuda",
                    help="where the model and the pools live (cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--spec", action="store_true",
                    help="speculative decoding + garbage drafter")
    ap.add_argument("--kernel-failure", action="store_true",
                    help="make the first decode call's kernel fail")
    ap.add_argument("--no-trace", action="store_true",
                    help="disable span timelines + the flight recorder "
                         "(on by default: the chaos run doubles as the "
                         "observability acceptance check)")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.config))
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = lm_init(gen, cfg)
    kw = {}
    if args.spec:
        kw["spec"] = SpecConfig(
            drafter=GarbageDrafter(cfg.vocab_size, seed=args.seed),
            disable_after_rejects=2,
        )
    if not args.no_trace:
        kw["trace"] = True
        kw["flight_recorder"] = 256
    eng = ServeEngine(
        cfg, params, batch_size=2, max_len=64, backend=args.backend,
        max_queue=8, device=args.device, **kw,
    )
    stats = run_chaos(eng, n_requests=args.requests, seed=args.seed,
                      kernel_failure=args.kernel_failure)
    for k, v in sorted(stats.items()):
        print(f"CHAOS {k}={v}")
    if eng.recorder is not None and eng.recorder.last_dump is not None:
        print("-- flight recorder (last stall dump) --")
        print(eng.recorder.render(
            6, records=eng.recorder.last_dump["records"]))
    print("CHAOS leak_free=1")


if __name__ == "__main__":
    _main()
