"""The port's observability surface (``serve/tracing.py``,
``serve/metrics.py``, ``serve/exporter.py``), held against the JAX
package (the counterparts of ``tests/test_observability.py``):

- tracing and the flight recorder change no served token (greedy and
  sampled rows, both backends), and every traced request's timeline
  validates, speculative bursts included;
- ``timeline``, ``validate_timeline`` and ``render_timeline`` give what
  the reference functions give on the same traced requests;
- the flight recorder's ring bounds and dump, and the tick record's key
  set equal to the JAX engine's (``jit_cache_sizes`` is the empty tuple
  in the port, which compiles nothing);
- ``ProgramTimer`` is a transparent wrapper;
- the exporter round-trips: the port's text parsed by both packages'
  ``parse_prometheus`` gives one dict; malformed text is refused;
- ``Histogram`` summaries equal the reference's on a seeded series;
  ``collect_engine_metrics`` overwrites;
- the HTTP ``/metrics`` and ``/healthz`` endpoints, and a shed
  request's timeline.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import asyncio
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import lm_init, segment_plan
from repro_torch.optim import tree_map
from repro_torch.serve import (
    AsyncServer,
    FlightRecorder,
    Histogram,
    ProgramTimer,
    Request,
    SamplingParams,
    ServeEngine,
    ServeMetrics,
    ServerConfig,
    ShedError,
    SpecConfig,
    collect_engine_metrics,
    parse_prometheus,
    render_prometheus,
    render_timeline,
    timeline,
    validate_timeline,
)

SAMPLED = [
    SamplingParams(temperature=0.0),
    SamplingParams(temperature=1.0, seed=21),
    SamplingParams(temperature=0.9, top_k=8, seed=22),
    SamplingParams(temperature=1.1, top_p=0.9, seed=23),
    SamplingParams(temperature=0.0),
]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import repro.serve as jserve
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced

    return types.SimpleNamespace(jax=jax, jnp=jnp, serve=jserve,
                                 get_config=jget_config, reduced=jreduced)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(reduced(get_config("llama3-8b")),
                              dtype="float32")
    return cfg, lm_init(torch.Generator().manual_seed(0), cfg)


def _engine(setup, **kw):
    cfg, params = setup
    kw.setdefault("batch_size", 2)
    return ServeEngine(cfg, params, max_len=64, cache_dtype=torch.float32,
                       device="cpu", **kw)


def _run(setup, backend, trace, spec=None):
    eng = _engine(setup, backend=backend, spec=spec, trace=trace,
                  flight_recorder=64 if trace else 0)
    reqs = [Request(prompt=[1 + i, 2, 3 + (i % 4), 4], max_new_tokens=6,
                    sampling=s) for i, s in enumerate(SAMPLED)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, reqs


# -- tracing ---------------------------------------------------------------


@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_tracing_bitwise_tokens(setup, backend):
    """Tracing and the flight recorder are host side only: the same
    tokens with them on and off (greedy and sampled rows); untraced
    requests carry no spans; every traced timeline validates."""
    _, off = _run(setup, backend, trace=False)
    eng, on = _run(setup, backend, trace=True)
    assert [r.out for r in on] == [r.out for r in off]
    assert all(r.spans is None for r in off)
    for r in on:
        validate_timeline(r)
    assert eng.jit_cache_sizes() == ()


def test_timeline_functions_match_the_reference(jx, setup):
    """On the same traced requests (one speculative run, so spec_burst
    spans are counted too) the port's ``timeline``, ``validate_timeline``
    and ``render_timeline`` give the reference functions' results."""
    _, reqs = _run(setup, "contiguous", trace=True)
    eng, spec_reqs = _run(setup, "paged", trace=True, spec=SpecConfig(k=3))
    bursts = [a for r in spec_reqs for _, k, a in r.spans
              if k == "spec_burst"]
    assert bursts and all(0 <= b["accepted"] <= b["drafted"]
                          for b in bursts)
    for r in reqs + spec_reqs:
        validate_timeline(r)
        jx.serve.validate_timeline(r)
        assert timeline(r) == jx.serve.timeline(r)
    tl = timeline(reqs[0])
    kinds = [s["kind"] for s in tl["spans"]]
    assert kinds[0] == "submitted" and kinds[-1] == "retired"
    assert kinds.count("decode_tick") == 6 == tl["n_tokens"]
    assert 0.0 <= tl["queue_s"] <= tl["total_s"] and tl["ttft_s"] > 0
    for width in (40, 64):
        assert (render_timeline(reqs, width=width)
                == jx.serve.render_timeline(reqs, width=width))
    assert render_timeline([]) == "(no traced requests)"
    # a broken timeline is refused by both
    bad = reqs[1]
    bad.spans = bad.spans[:-1]
    for check in (validate_timeline, jx.serve.validate_timeline):
        with pytest.raises(AssertionError, match="retired"):
            check(bad)


def test_flight_recorder_ring_and_record_keys(jx, setup, tmp_path):
    """The ring keeps the last ``capacity`` records and dumps them as
    JSON; the engine's tick record has the JAX engine's key set and its
    program timers count the calls."""
    rec = FlightRecorder(capacity=4)
    jrec = jx.serve.FlightRecorder(capacity=4)
    for i in range(10):
        rec.record({"tick": i})
        jrec.record({"tick": i})
    assert rec.records() == jrec.records()
    path = tmp_path / "dump.json"
    out = rec.dump("test_reason", path=str(path))
    assert out == jrec.dump("test_reason")
    assert rec.dumps == 1 and rec.last_dump_path == str(path)
    assert json.loads(path.read_text())["records"] == [
        {"tick": t} for t in (6, 7, 8, 9)]
    assert rec.render(2) == jrec.render(2)

    cfg, params = setup
    jcfg = dataclasses.replace(jx.reduced(jx.get_config("llama3-8b")),
                               dtype="float32")
    tree = {k: tree_map(lambda t: t.numpy(), v) for k, v in params.items()
            if k != "layers"}
    tree["segments"] = [
        tree_map(lambda *ts: np.stack([t.numpy() for t in ts]),
                 *params["layers"][s:s + c]) for s, c, _ in segment_plan(cfg)]
    jparams = jx.jax.tree_util.tree_map(jx.jnp.asarray, tree)
    keys = []
    for backend in ("paged", "contiguous"):
        jeng = jx.serve.ServeEngine(jcfg, jparams, batch_size=2, max_len=64,
                                    backend=backend, flight_recorder=8,
                                    cache_dtype=jx.jnp.float32)
        eng = _engine(setup, backend=backend, flight_recorder=8)
        for e, req in ((jeng, jx.serve.Request), (eng, Request)):
            e.submit(req(prompt=[1, 2, 3], max_new_tokens=3))
            e.run()
        keys.append([set(e.recorder.records()[-1]) for e in (jeng, eng)])
        assert keys[-1][0] == keys[-1][1]
        assert eng.recorder.ticks == eng.ticks
        recs = eng.recorder.records()
        assert any(r["programs"]["decode"]["calls"] for r in recs)
        assert any(r["programs"]["prefill_chunk"]["calls"] for r in recs)
        assert all(r["jit_cache_sizes"] == () for r in recs)
    assert keys[0][0] > keys[1][0]  # the paged record adds block counts


def test_program_timer_transparent_wrapper():
    class Fn:
        bound_attr = 41

        def __call__(self, x):
            return x + 1

    t = ProgramTimer("f", Fn())
    assert t(1) == 2 and t(2) == 3
    assert t.calls == 2 and t.total_s >= 0.0
    assert t.take_tick()["calls"] == 2
    assert t.take_tick()["calls"] == 0  # drained
    assert t.calls == 2 and t.bound_attr == 41
    t.reset()
    assert t.calls == 0 and t.total_s == 0.0


# -- metrics and exporter ---------------------------------------------------


def test_histogram_and_snapshot_match_the_reference(jx):
    """Seeded latency series (some past the last bucket): bucket counts,
    cumulative counts and the snapshot summary equal the reference's."""
    rng = np.random.RandomState(0)
    vals = np.concatenate([rng.exponential(0.05, 300), [0.0, 61.0, 120.0]])
    h, jh = Histogram(), jx.serve.Histogram()
    m, jm = ServeMetrics(), jx.serve.ServeMetrics()
    for v in vals:
        h.observe(v)
        jh.observe(v)
        m.observe("latency_s", v)
        jm.observe("latency_s", v)
    assert h.bucket_counts == jh.bucket_counts
    assert h.cumulative() == jh.cumulative()
    assert h.summary() == jh.summary()
    for mm in (m, jm):
        mm.inc("sheds", 3)
        mm.set_gauge("program_efficiency", 0.25, program="decode")
        mm.set_gauge("program_efficiency", 0.5, program="verify")
    assert m.snapshot() == jm.snapshot()
    small = ServeMetrics()
    for v in (10.0, 20.0, 30.0, 40.0):
        small.observe("four", v)
    assert small.snapshot()["four"]["p50"] == 20.0


def test_collect_engine_metrics_overwrites():
    stub = types.SimpleNamespace(preemptions=3)
    stub.robustness_stats = lambda: {"preemptions": stub.preemptions,
                                     "kernel_fallbacks": 1}
    m = ServeMetrics()
    collect_engine_metrics(stub, m)
    collect_engine_metrics(stub, m)
    assert m.counters["preemptions"] == 3  # not 6
    stub.preemptions = 5
    collect_engine_metrics(stub, m)
    assert m.counters["preemptions"] == 5


def test_exporter_round_trip_matches_the_reference(jx):
    """The port's exposition parsed by both packages' strict parsers gives
    one dict; the reference's renderer gives the same text; malformed
    text and broken histograms are refused."""
    m = ServeMetrics()
    m.inc("sheds", 3)
    m.inc("deadline_misses_total", 2)
    for v in (0.0005, 0.02, 0.3, 7.0, 120.0):
        m.observe("latency_s", v)
    m.set_gauge("program_efficiency", 0.125, program="decode")
    info = {"arch": 'we"ird\\la\nbel', "block_size": 16, "spec": "off"}
    text = render_prometheus(m, info=info)
    parsed = parse_prometheus(text)
    assert parsed == jx.serve.parse_prometheus(text)
    assert text == jx.serve.render_prometheus(m, info=info)
    assert parsed["counters"]["repro_serve_deadline_misses_total"] == 2
    h = parsed["histograms"]["repro_serve_latency_s"]
    assert h["count"] == 5 and h["buckets"][-1] == (float("inf"), 5)
    labels, value = parsed["gauges"]["repro_serve_engine_info"]
    assert value == 1.0 and labels["arch"] == 'we"ird\\la\nbel'
    for bad in ("not a metric line{\n", "# random comment\n",
                'm_bucket{le="0.1" 3\n', "m 1\n\nm2 2\n"):
        with pytest.raises(ValueError):
            parse_prometheus(bad)
    with pytest.raises(AssertionError):
        parse_prometheus('h_bucket{le="0.1"} 5\nh_bucket{le="+Inf"} 3\n'
                         "h_sum 1.0\nh_count 3\n")
    with pytest.raises(AssertionError, match="reserved"):
        m.set_gauge("x_total", 1.0)


# -- the server's endpoints ------------------------------------------------


async def _get(host, port, path):
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: _\r\n\r\n".encode("ascii"))
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = dict(line.split(": ", 1) for line in lines[1:] if ": " in line)
    return int(lines[0].split()[1]), headers, body.decode("utf-8")


def test_http_metrics_and_healthz_endpoints(setup):
    """Over the server's socket: /metrics parses strictly, with the
    completed counter, the TTFT histogram and the engine_info gauge of a
    traced paged engine; /healthz is ok; other paths are 404."""

    async def go():
        eng = _engine(setup, backend="paged", trace=True, flight_recorder=16)
        async with AsyncServer(eng, ServerConfig(metrics_port=0)) as srv:
            await srv.complete([1, 2, 3], max_new_tokens=4)
            host, port = srv.metrics_addr
            return [await _get(host, port, p)
                    for p in ("/metrics", "/healthz", "/nope")]

    (status, headers, body), health, missing = asyncio.run(go())
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain; version=0.0.4")
    parsed = parse_prometheus(body)
    assert parsed["counters"]["repro_serve_completed_total"] == 1
    assert parsed["counters"]["repro_serve_kernel_fallbacks_total"] == 0
    assert parsed["histograms"]["repro_serve_ttft_s"]["count"] == 1
    labels, _ = parsed["gauges"]["repro_serve_engine_info"]
    assert labels["backend"] == "paged" and labels["trace"] == "on"
    assert "repro_serve_program_efficiency" in parsed["gauges"]
    status, headers, body = health
    assert status == 200 and headers["Content-Type"] == "application/json"
    h = json.loads(body)
    assert h["status"] == "ok" and h["pump_alive"]
    assert h["open_streams"] == 0 and h["watchdog_stalls"] == 0
    assert missing[0] == 404


def test_shed_request_timeline(setup):
    """Sheds never reach the engine's submit: the server opens and closes
    their timelines, which validate with reason "shed"."""

    async def go():
        eng = _engine(setup, batch_size=1, trace=True)
        scfg = ServerConfig(max_queue=1, max_retries=0,
                            max_demand_factor=0.5)
        async with AsyncServer(eng, scfg) as srv:
            reqs = [await srv.submit([1, 2, 3], max_new_tokens=6)]
            shed = []
            for i in range(6):
                try:
                    reqs.append(await srv.submit([4, 5, i], max_new_tokens=6))
                except ShedError as e:
                    shed.append(e)
            for r in reqs:
                async for _ in srv.stream(r):
                    pass
        return eng, reqs, shed

    eng, reqs, shed = asyncio.run(go())
    assert shed and eng.tracer.started == len(reqs) + len(shed)
    for r in reqs:
        validate_timeline(r)
