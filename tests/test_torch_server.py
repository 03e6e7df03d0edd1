"""The port's asyncio serving front end (``serve/server.py``; the
counterparts of ``tests/test_server.py``'s cases): token parity with
the engine driven directly on both backends (greedy and sampled rows),
incremental streaming, cancellation that frees a row within one tick, a
queued cancel that binds no memory, an abandoned stream freeing its
slot, deadlines, the bounded queue, shedding with its reason, retry
with backoff, latency metrics, percentiles against the reference, the
watchdog's arming and its recorder dump, and a kernel failure that stops
the pump with every stream ended in "error". On the card (``cuda`` marker):
the kernel engine's server parity and the speculative engine in f32.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import asyncio
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import lm_init
from repro_torch.serve import (
    AsyncServer,
    FaultInjector,
    KernelFailure,
    QueueFull,
    Request,
    SamplingParams,
    ServeEngine,
    ServeMetrics,
    ServerConfig,
    ShedError,
    SpecConfig,
    Watchdog,
    pool_snapshot,
    validate_timeline,
)

SAMPLED = [
    SamplingParams(temperature=0.0),
    SamplingParams(temperature=1.0, seed=11),
    SamplingParams(temperature=0.9, top_k=8, seed=12),
    SamplingParams(temperature=1.1, top_p=0.9, seed=13),
    SamplingParams(temperature=0.0),
]

_PARAMS = {}


def _setup(device="cpu"):
    if device not in _PARAMS:
        cfg = dataclasses.replace(reduced(get_config("llama3-8b")),
                                  dtype="float32")
        gen = torch.Generator(device=device).manual_seed(0)
        _PARAMS[device] = (cfg, lm_init(gen, cfg))
    return _PARAMS[device]


def _engine(batch=2, device="cpu", **kw):
    cfg, params = _setup(device)
    return ServeEngine(cfg, params, batch_size=batch, max_len=64,
                       cache_dtype=torch.float32, device=device, **kw)


def _prompts(n):
    return [[1 + i, 2, 3 + (i % 4), 4] for i in range(n)]


def _direct(prompts, samplings, **kw):
    eng = _engine(**kw)
    reqs = [Request(prompt=list(p), max_new_tokens=6, sampling=s)
            for p, s in zip(prompts, samplings)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out for r in reqs]


def _served(prompts, samplings, **kw):
    async def go():
        async with AsyncServer(_engine(**kw)) as srv:
            reqs = await asyncio.gather(*[
                srv.complete(p, max_new_tokens=6, sampling=s)
                for p, s in zip(prompts, samplings)])
        return [r.out for r in reqs]

    return asyncio.run(go())


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_server_token_parity_with_direct_engine(backend):
    prompts = _prompts(5)
    assert (_served(prompts, SAMPLED, backend=backend)
            == _direct(prompts, SAMPLED, backend=backend))


def test_streaming_tokens_arrive_incrementally_and_match_final():
    async def go():
        async with AsyncServer(_engine()) as srv:
            req = await srv.submit([1, 2, 3], max_new_tokens=5)
            seen = []
            async for tok in srv.stream(req):
                assert req.out[len(seen)] == tok  # committed before yield
                seen.append(tok)
        return seen, req

    seen, req = asyncio.run(go())
    assert req.done and req.finish_reason == "length"
    assert seen == req.out and len(seen) == 5


def test_kernel_failure_stops_the_pump_and_ends_every_stream():
    """A kernel that fails to launch inside the pump is not hidden behind
    another path: the rows of the failed call end with "error" (the
    engine), the pump stops and ends every other open request with
    "error", no stream hangs, /healthz reads "crashed", and stopping the
    server raises the failure."""
    eng = _engine(backend="paged")
    FaultInjector(eng).inject_kernel_failure(after_calls=2)

    async def go():
        srv = AsyncServer(eng)
        await srv.start()
        reqs = await asyncio.gather(*[srv.complete(p, max_new_tokens=6)
                                      for p in _prompts(3)])
        health = srv.health()
        with pytest.raises(KernelFailure, match="injected kernel failure"):
            await srv.stop()
        return reqs, health

    reqs, health = asyncio.run(go())
    assert all(r.done and r.finish_reason == "error" for r in reqs)
    assert all(len(r.out) < 6 for r in reqs)
    assert health["status"] == "crashed" and not health["pump_alive"]
    assert eng.backend.use_kernel


def test_cancellation_frees_all_row_resources_within_one_tick():
    eng = _engine(batch=1, backend="paged", prefix_cache=False)
    baseline = pool_snapshot(eng)
    req = Request(prompt=[1, 2, 3], max_new_tokens=32)
    eng.submit(req)
    for _ in range(6):
        eng.step()
    assert not req.done and eng.sched.live
    assert eng.cancel(req)
    assert req.done and req.finish_reason == "cancelled"
    snap = pool_snapshot(eng)  # no step in between
    for key, want in baseline.items():
        assert np.array_equal(snap[key], want), key
    assert not eng.cancel(req)  # already finished


def test_cancelled_queued_request_never_binds_memory():
    eng = _engine(batch=1)
    hog = Request(prompt=[1, 2, 3], max_new_tokens=8)
    queued = Request(prompt=[4, 5, 6], max_new_tokens=8)
    eng.submit(hog)
    eng.submit(queued)
    eng.step()
    assert eng.cancel(queued)
    assert queued.finish_reason == "cancelled" and queued.out == []
    eng.run()
    assert hog.done and len(hog.out) == 8


def test_abandoned_stream_frees_slot_for_next_request():
    async def go():
        async with AsyncServer(_engine(batch=1)) as srv:
            req = await srv.submit([1, 2, 3], max_new_tokens=40)
            got = []
            async for tok in srv.stream(req):
                got.append(tok)
                if len(got) == 3:
                    break  # abandoning the stream cancels
            nxt = await srv.complete([7, 8, 9], max_new_tokens=4)
            snap = srv.snapshot()
        return req, got, nxt, snap

    req, got, nxt, snap = asyncio.run(go())
    assert req.finish_reason == "cancelled" and len(got) == 3
    assert nxt.done and len(nxt.out) == 4
    assert snap["client_cancellations"] == 1


def test_deadline_expiry_queued_and_live():
    eng = _engine(batch=1)
    live = Request(prompt=[1, 2, 3], max_new_tokens=32, deadline_s=60.0)
    eng.submit(live)
    for _ in range(3):
        eng.step()
    assert eng.sched.live and not live.done
    queued = Request(prompt=[4, 5], max_new_tokens=4, ttft_deadline_s=0.0)
    eng.submit(queued)
    live.t_submit -= 100.0  # the total deadline passes, no sleep
    eng.step()
    assert live.finish_reason == "deadline"
    assert queued.finish_reason == "deadline" and queued.out == []
    assert eng.deadline_misses == {"ttft": 1, "total": 1}
    assert eng.backend.num_free_slots == 1 and not eng.sched.pending()


def test_scheduler_bounded_queue_rejects_explicitly():
    eng = _engine(max_queue=2)
    for i in range(2):
        eng.submit(Request(prompt=[1 + i], max_new_tokens=2))
    with pytest.raises(QueueFull):
        eng.submit(Request(prompt=[9], max_new_tokens=2))
    eng.run()
    assert eng.sched.max_queue == 2


def test_overload_sheds_with_reason_and_counts():
    async def go():
        scfg = ServerConfig(max_queue=2, max_retries=0,
                            max_demand_factor=0.6)
        async with AsyncServer(_engine(batch=1), scfg) as srv:
            results = await asyncio.gather(*[
                srv.complete([1, 2, 3 + i], max_new_tokens=8)
                for i in range(8)], return_exceptions=True)
            snap = srv.snapshot()
        return results, snap

    results, snap = asyncio.run(go())
    sheds = [r for r in results if isinstance(r, ShedError)]
    done = [r for r in results if isinstance(r, Request)]
    assert sheds and done and len(sheds) + len(done) == 8
    assert all(r.reason in ("queue_full", "memory") for r in sheds)
    assert all(r.finish_reason == "length" for r in done)
    assert snap["sheds"] == len(sheds) == (snap.get("shed_queue_full", 0)
                                           + snap.get("shed_memory", 0))
    assert snap["completed"] == len(done)


def test_shed_retry_with_backoff_eventually_admits():
    async def go():
        scfg = ServerConfig(max_queue=1, max_retries=12,
                            retry_backoff_s=0.02)
        async with AsyncServer(_engine(batch=2), scfg) as srv:
            results = await asyncio.gather(*[
                srv.complete([1, 2, 3 + i], max_new_tokens=4)
                for i in range(6)])
            snap = srv.snapshot()
        return results, snap

    results, snap = asyncio.run(go())
    assert all(r.finish_reason == "length" for r in results)
    assert snap["shed_retries"] > 0 and snap.get("sheds", 0) == 0


def test_server_latency_metrics_observed():
    async def go():
        async with AsyncServer(_engine()) as srv:
            await srv.complete([1, 2, 3], max_new_tokens=4)
            return srv.snapshot(), srv.health()

    snap, health = asyncio.run(go())
    for name in ("queue_time_s", "ttft_s", "latency_s"):
        assert snap[name]["count"] == 1 and snap[name]["p50"] >= 0.0
    assert snap["submitted"] == 1 and snap["completed"] == 1
    assert snap["kernel_fallbacks"] == 0 and snap["watchdog_stalls"] == 0
    assert health["status"] == "ok" and health["open_streams"] == 0


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import repro.serve as jserve

    return jserve


def test_metrics_percentiles_match_the_reference(jx):
    """Nearest-rank percentiles on 0..99 and on tiny series, and merged
    counters (overwrite), equal the reference's snapshot."""
    series = {"x": [float(v) for v in range(100)], "one": [5.0],
              "two": [1.0, 2.0], "three": [1.0, 2.0, 3.0],
              "four": [10.0, 20.0, 30.0, 40.0]}
    m, jm = ServeMetrics(), jx.ServeMetrics()
    for mm in (m, jm):
        for name, vals in series.items():
            for v in vals:
                mm.observe(name, v)
        mm.inc("a")
        mm.merge_counters({"a": 7})
    snap = m.snapshot()
    assert snap == jm.snapshot()
    assert snap["a"] == 7
    assert (snap["x"]["p50"], snap["x"]["p99"]) == (49.0, 98.0)
    assert snap["two"]["p50"] == 1.0 and snap["four"]["p50"] == 20.0


def test_watchdog_arming():
    """Fires once per stall episode (edge triggered); only progress
    rearms it and restarts its clock; idle never stalls."""
    fired = []
    wd = Watchdog(stall_s=0.02, on_stall=fired.append)
    assert not wd.beat(progressed=True, pending=True)
    time.sleep(0.03)
    assert wd.beat(progressed=False, pending=True)
    time.sleep(0.03)
    assert not wd.beat(progressed=False, pending=True)  # no re-fire
    assert not wd.beat(progressed=True, pending=True)  # rearm
    assert not wd.beat(progressed=False, pending=True)  # clock reset
    time.sleep(0.03)
    assert wd.beat(progressed=False, pending=True)
    assert wd.stalls == 2 and len(fired) == 2
    assert all(d >= 0.02 for d in fired) and wd.last_stall_s == fired[-1]
    idle = Watchdog(stall_s=0.01)
    time.sleep(0.02)
    assert not idle.beat(progressed=False, pending=False)


def test_watchdog_stall_dumps_the_flight_recorder(tmp_path):
    """Pool exhaustion with pending work: the server's watchdog fires,
    the stall lands in the watchdog_stall_s series, the recorder dumps to
    dump_dir, and the request completes once the pool is released."""

    async def go():
        eng = _engine(batch=1, backend="paged", prefix_cache=False,
                      trace=True, flight_recorder=32)
        inj = FaultInjector(eng, seed=0)
        scfg = ServerConfig(watchdog_stall_s=0.05, dump_dir=str(tmp_path))
        async with AsyncServer(eng, scfg) as srv:
            inj.hold_blocks()
            task = asyncio.create_task(
                srv.complete([1, 2, 3], max_new_tokens=2))
            for _ in range(400):
                await asyncio.sleep(0.01)
                if srv.watchdog.stalls:
                    break
            inj.release_blocks()
            req = await task
            snap = srv.snapshot()
        inj.detach()
        return eng, req, snap

    eng, req, snap = asyncio.run(go())
    assert snap["watchdog_stalls"] >= 1
    assert snap["watchdog_stall_s"]["p50"] >= 0.05
    assert req.finish_reason == "length"
    validate_timeline(req)
    assert eng.recorder.last_dump["reason"] == "watchdog_stall"
    dumps = sorted(tmp_path.glob("flight_watchdog_stall_*.json"))
    assert dumps and json.loads(dumps[0].read_text())["records"]


# -- on the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch sees none)")


@pytest.mark.cuda
def test_kernel_engine_server_parity_on_the_card(card):
    """The paged kernel engine behind the server serves the tokens of the
    same engine driven directly, with K7 launched once a layer a decode
    step."""
    from repro_torch.kernels.paged_attention import paged_decode_attend

    prompts = _prompts(5)
    kw = dict(backend="paged", device="cuda")
    want = _direct(prompts, SAMPLED, **kw)

    async def go():
        eng = _engine(trace=True, flight_recorder=16, **kw)
        paged_decode_attend.launches = 0
        async with AsyncServer(eng) as srv:
            reqs = await asyncio.gather(*[
                srv.complete(p, max_new_tokens=6, sampling=s)
                for p, s in zip(prompts, SAMPLED)])
        return eng, [r.out for r in reqs]

    eng, got = asyncio.run(go())
    assert got == want
    assert paged_decode_attend.launches == (eng.decode_steps
                                            * eng.cfg.num_layers)


@pytest.mark.cuda
def test_speculative_engine_f32_on_the_card(card):
    """In f32 on the card the speculative engine (its verify gathers, K7
    launches 0 times) gives the plain kernel engine's greedy tokens, and
    the pool is leak-free after the drain."""
    from repro_torch.kernels.paged_attention import paged_decode_attend
    from repro_torch.serve import assert_leak_free

    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 5, 6, 5, 6], [4] * 9]
    kw = dict(backend="paged", device="cuda")
    want = _direct(prompts, [SamplingParams()] * 3, **kw)
    eng = _engine(spec=SpecConfig(k=4), **kw)
    paged_decode_attend.launches = 0
    reqs = [Request(prompt=list(p), max_new_tokens=6) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert paged_decode_attend.launches == 0
    assert [r.out for r in reqs] == want
    assert eng.spec_stats()["verify_calls"] > 0
    assert_leak_free(eng)
