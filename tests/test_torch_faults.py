"""Fault injection and the chaos harness in the port
(``serve/faults.py``; the counterparts of ``tests/test_faults.py`` and
``tests/test_chaos.py``):

- a poisoned row retires alone (finish_reason "error"), the bystander's
  stream unchanged, on both backends;
- an injected kernel failure raises out of the tick (the port has no
  kernel-to-gather fallback), the rows of the failed call retire with
  "error", the engine keeps serving on the kernel the tokens of a clean
  kernel engine, and the pool is leak-free; on an arch with SSM rows
  too;
- pool exhaustion stalls admission and recovers; garbage and flaky
  drafters change no token; a latency spike is not fatal; ``detach``
  restores the backend;
- ``run_chaos`` is leak-free on paged (the pool equal to a fresh
  engine's, field by field), paged with the prefix cache, contiguous and
  speculative, is deterministic in its seed, and its per-request finish
  reasons and tokens equal the JAX ``run_chaos``'s on the paged backend.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import lm_init, segment_plan
from repro_torch.optim import tree_map
from repro_torch.serve import (
    FaultInjector,
    FlakyDrafter,
    GarbageDrafter,
    Request,
    ServeEngine,
    SpecConfig,
    assert_leak_free,
    pool_snapshot,
    run_chaos,
)
from repro_torch.serve import faults as tfaults


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import repro.serve as jserve
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.serve import faults as jfaults

    return types.SimpleNamespace(jax=jax, jnp=jnp, serve=jserve,
                                 faults=jfaults, get_config=jget_config,
                                 reduced=jreduced)


_PARAMS = {}


def _setup(name="llama3-8b"):
    if name not in _PARAMS:
        cfg = dataclasses.replace(reduced(get_config(name)), dtype="float32")
        _PARAMS[name] = (cfg, lm_init(torch.Generator().manual_seed(0), cfg))
    return _PARAMS[name]


def _engine(batch=2, name="llama3-8b", **kw):
    cfg, params = _setup(name)
    return ServeEngine(cfg, params, batch_size=batch, max_len=64,
                       cache_dtype=torch.float32, device="cpu", **kw)


def _reqs(n, max_new=6):
    return [Request(prompt=[1 + i, 2, 3], max_new_tokens=max_new)
            for i in range(n)]


def _outputs(eng, n, max_new=6):
    reqs = _reqs(n, max_new)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs


def _snapshots_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(got[key], want[key]), (key, got[key],
                                                     want[key])


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_nan_logits_retire_only_the_poisoned_row(backend):
    clean = [r.out for r in _outputs(_engine(backend=backend), 2, 8)]
    eng = _engine(backend=backend)
    inj = FaultInjector(eng)
    reqs = _reqs(2, max_new=8)
    for r in reqs:
        eng.submit(r)
    while (len(eng.sched.live) < 2
           or not all(e.state == "decode" for e in eng.sched.live.values())):
        eng.step()
    victim = next(s for s, e in eng.sched.live.items() if e.req is reqs[0])
    inj.poison_logits(victim, after_calls=2)
    eng.run()
    assert reqs[0].finish_reason == "error" and len(reqs[0].out) < 8
    assert reqs[1].finish_reason == "length" and reqs[1].out == clean[1]
    assert eng.nonfinite_retired == 1 and inj.nan_injected == 1
    inj.detach()
    assert_leak_free(eng)


def test_poison_writes_a_copy_of_the_logits():
    """The injector NaNs a copy: the tensor the backend returned (and any
    buffer it keeps) stays finite."""
    eng = _engine(backend="paged")
    seen = []
    inner = eng.backend.decode

    def spy(*a):
        out = inner(*a)
        seen.append(out)
        return out

    eng.backend.decode = spy
    inj = FaultInjector(eng)
    eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
    while not eng.sched.decode_entries():
        eng.step()
    inj.poison_logits(next(iter(eng.sched.live)), after_calls=1)
    eng.run()
    assert inj.nan_injected == 1 and seen
    assert all(torch.isfinite(t).all() for t in seen)
    inj.detach()


@pytest.mark.parametrize("name", ["llama3-8b", "mamba2-370m"])
def test_kernel_failure_raises_and_retires_the_call_rows(name):
    """A kernel that fails to build or launch raises out of
    ``engine.step()``; it is not replaced by the gather path. The two rows
    of the failed decode call retire with "error" after the tokens they
    had (a clean engine's first tokens), the queued third request is then
    served on the kernel with the tokens of a clean engine serving it
    alone, and the pool ends leak-free."""
    want = [r.out for r in _outputs(_engine(name=name, backend="paged"), 2)]
    alone = _engine(name=name, backend="paged")
    r3 = _reqs(3)[2]
    alone.submit(r3)
    alone.run()
    eng = _engine(name=name, backend="paged")
    inj = FaultInjector(eng)
    reqs = _reqs(3)
    for r in reqs:
        eng.submit(r)
    while (len(eng.sched.live) < 2
           or not all(e.state == "decode" for e in eng.sched.live.values())):
        eng.step()
    inj.inject_kernel_failure(after_calls=2)
    eng.step()
    with pytest.raises(tfaults.KernelFailure, match="injected kernel"):
        eng.step()
    assert inj.kernel_failures == 1
    for r, w in zip(reqs[:2], want):
        assert r.done and r.finish_reason == "error"
        assert 1 <= len(r.out) < len(w) and r.out == w[:len(r.out)]
    assert eng.backend.use_kernel
    assert eng.robustness_stats()["kernel_fallbacks"] == 0
    eng.run()
    assert reqs[2].finish_reason == "length"
    assert reqs[2].out == r3.out
    inj.detach()
    assert_leak_free(eng)


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_pool_exhaustion_stalls_admission_then_recovers(backend):
    eng = _engine(backend=backend, prefix_cache=False)
    inj = FaultInjector(eng)
    assert inj.hold_blocks() > 0
    reqs = _reqs(2)
    for r in reqs:
        eng.submit(r)
    for _ in range(5):
        eng.step()
    assert all(not r.done for r in reqs) and not eng.sched.live
    inj.release_blocks()
    eng.run()
    assert all(r.finish_reason == "length" for r in reqs)
    inj.detach()
    assert_leak_free(eng)


def test_misbehaving_drafters_change_no_token():
    """Garbage drafts (half out of vocab) and a drafter that raises cost
    acceptance, never correctness; the per-row kill switch turns drafting
    off, and the counts reach robustness_stats."""
    cfg, _ = _setup()
    clean = [r.out for r in _outputs(_engine(), 2, 10)]
    eng = _engine(spec=SpecConfig(
        drafter=GarbageDrafter(cfg.vocab_size, seed=3),
        disable_after_rejects=2))
    assert [r.out for r in _outputs(eng, 2, 10)] == clean
    assert eng.robustness_stats()["spec_rows_disabled"] >= 1
    assert_leak_free(eng)
    eng = _engine(spec=SpecConfig(drafter=FlakyDrafter(ok_calls=1),
                                  max_drafter_errors=2))
    reqs = _outputs(eng, 2, 10)
    assert [r.out for r in reqs] == clean
    assert eng._spec.drafter_errors > 0 and eng._spec.rows_disabled >= 1
    assert eng.robustness_stats()["spec_drafter_errors"] > 0
    assert_leak_free(eng)


def test_latency_spike_and_detach():
    eng = _engine()
    orig = eng.backend.decode
    inj = FaultInjector(eng)
    assert eng.backend.decode is not orig
    inj.latency_spike(0.01, after_calls=1)
    assert all(r.finish_reason == "length" for r in _outputs(eng, 2))
    assert inj.latency_injected == 1
    inj.hold_blocks(1)
    inj.detach()
    assert eng.backend.decode == orig
    assert eng.backend.num_free_slots == 2  # the held slot came back
    assert_leak_free(eng)


# -- run_chaos --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_paged_pool_matches_fresh_engine(seed):
    """Prefix cache off, traced: after the storm the pool equals a fresh
    engine's field by field, every timeline validated, a stall dumped."""

    def build():
        return _engine(backend="paged", prefix_cache=False, max_queue=6,
                       trace=True, flight_recorder=64)

    fresh = pool_snapshot(build())
    eng = build()
    stats = run_chaos(eng, n_requests=14, seed=seed)
    _snapshots_equal(pool_snapshot(eng), fresh)
    assert stats["cancellations"] + stats.get("finish_deadline", 0) > 0
    assert stats["timelines_valid"] == 14 and stats["stall_dumps"] >= 1
    assert stats["kernel_fallbacks"] == 0


def test_chaos_prefix_cache_contiguous_and_speculative():
    """With the radix tree on, the leak check flushes it and demands an
    empty pool; the contiguous pool ends with every slot free; a
    speculative engine with a garbage drafter unwinds its pending tokens
    and burst reservations through cancellations and poisonings; an
    injected kernel failure surfaces from one tick, once, and the pool
    still ends empty."""
    cfg, _ = _setup()
    eng = _engine(backend="paged", prefix_cache=True, max_queue=6)
    run_chaos(eng, n_requests=12, seed=4)
    assert eng.backend.mgr.num_used == 0
    eng = _engine(max_queue=6)
    assert run_chaos(eng, n_requests=12, seed=5)["steps"] > 0
    assert sorted(eng.backend.pool._free) == [0, 1]
    eng = _engine(backend="paged", prefix_cache=False, max_queue=6,
                  spec=SpecConfig(drafter=GarbageDrafter(cfg.vocab_size,
                                                         seed=0),
                                  disable_after_rejects=2))
    run_chaos(eng, n_requests=10, seed=6)
    assert (eng._spec._pending < 0).all()
    eng = _engine(backend="paged", max_queue=6)
    stats = run_chaos(eng, n_requests=10, seed=3, kernel_failure=True)
    assert stats["kernel_failures"] == stats["kernel_failures_surfaced"] == 1
    assert stats["kernel_fallbacks"] == 0 and stats["finish_error"] >= 1
    assert eng.backend.use_kernel and eng.backend.mgr.num_used == 0


def test_chaos_is_deterministic_and_matches_jax(jx):
    """Same seed, same terminal states; and on the paged backend the
    port's run_chaos gives every request the JAX run_chaos's finish
    reason and tokens (f32 weights and caches, the gather path on both
    sides)."""
    cfg, params = _setup()

    def run(seed):
        eng = _engine(backend="paged", prefix_cache=False, max_queue=6,
                      use_kernel=False)
        stats = run_chaos(eng, n_requests=10, seed=seed)
        stats.pop("steps", None)
        return stats

    assert run(7) == run(7)
    jcfg = dataclasses.replace(jx.reduced(jx.get_config("llama3-8b")),
                               dtype="float32")
    tree = {k: tree_map(lambda t: t.numpy(), v) for k, v in params.items()
            if k != "layers"}
    tree["segments"] = [
        tree_map(lambda *ts: np.stack([t.numpy() for t in ts]),
                 *params["layers"][s:s + c]) for s, c, _ in segment_plan(cfg)]
    jparams = jx.jax.tree_util.tree_map(jx.jnp.asarray, tree)
    results = []
    for faults, make in (
            (tfaults, lambda: _engine(backend="paged", max_queue=6,
                                      use_kernel=False)),
            (jx.faults, lambda: jx.serve.ServeEngine(
                jcfg, jparams, batch_size=2, max_len=64, backend="paged",
                max_queue=6, use_kernel=False,
                cache_dtype=jx.jnp.float32))):
        reqs = []
        real = faults.Request

        def record(*a, _real=real, **kw):
            reqs.append(_real(*a, **kw))
            return reqs[-1]

        faults.Request = record
        try:
            stats = faults.run_chaos(make(), n_requests=14, seed=2)
        finally:
            faults.Request = real
        results.append((stats, [(r.finish_reason, r.out) for r in reqs]))
    (stats, got), (jstats, want) = results
    assert got == want
    assert {k: v for k, v in stats.items() if k.startswith("finish_")} == {
        k: v for k, v in jstats.items() if k.startswith("finish_")}
    assert stats["nan_injected"] == jstats["nan_injected"]
