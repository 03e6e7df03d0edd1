"""Fault-tolerant asyncio serving front end over ``ServeEngine``,
counterpart of ``repro/serve/server.py``.

``AsyncServer`` wraps the synchronous, single-threaded ``ServeEngine`` in
an asyncio event loop without changing a token it produces: requests
enter the engine through the same FIFO ``submit`` path, the engine steps
inside one pump task (the device is driven from one thread), and tokens
stream out through per-request ``asyncio.Queue``s fed by the engine's
``on_token`` callback. On a no-fault trace the server's outputs are
token for token those of the engine driven directly.

What the wrapper adds is the failure policy the bare engine lacks:

* **Admission control and load shedding.** Before a request reaches the
  engine, two budgets gate it: the scheduler's bounded queue
  (``QueueFull`` -> shed reason "queue_full") and estimated token
  demand: the sum of ``len(prompt) + max_new_tokens`` over every queued
  and live request may not exceed ``max_demand_factor`` x the backend's
  ``token_capacity()`` (shed reason "memory"). A shed is an explicit,
  reasoned reject (``ShedError``), never a silent drop.
* **Retry with backoff.** A shed submission retries up to
  ``max_retries`` times with exponential backoff before the request is
  finalized with ``finish_reason="shed"``; retries respect the request's
  deadline.
* **Deadlines.** Per-request TTFT / total deadlines ride on the Request
  fields the engine's tick loop enforces (finish_reason="deadline"); the
  server fills defaults and surfaces the misses as metrics.
* **Cancellation.** Closing a ``stream()``/``generate()`` consumer (or
  calling ``cancel(req)``) retires the row and frees its slot, blocks
  and pending speculative state within one engine tick.
* **Watchdog.** The pump feeds a stuck-step ``Watchdog``
  (``serve/metrics.py``): pending work with no progress for ``stall_s``
  raises the ``watchdog_stalls`` counter, records the stall as the
  ``watchdog_stall_s`` series and, when the engine runs a flight
  recorder, dumps the per-tick ring for a post-mortem (to ``dump_dir``
  if set, else in memory as ``recorder.last_dump``).
* **Observability endpoints.** With ``metrics_port`` set (0 = an
  ephemeral port) the server answers HTTP GETs on ``/metrics``
  (Prometheus text format, ``serve/exporter.py``) and ``/healthz`` (JSON
  liveness: pump state, queue depth, stall count; 503 once the pump has
  crashed).

The pump never lets an engine exception strand a stream: a crashed pump
finalizes every open request with finish_reason="error", wakes its
consumers, and dumps the flight recorder (reason "pump_crash") when one
is attached.
"""
from __future__ import annotations

import asyncio
import json
import os
import time
from dataclasses import dataclass
from typing import AsyncIterator, Dict, List, Optional

from .exporter import CONTENT_TYPE, render_prometheus
from .metrics import ServeMetrics, Watchdog, collect_engine_metrics
from .sampling import GREEDY, SamplingParams
from .scheduler import QueueFull, Request

_DONE = object()  # per-request stream sentinel


class ShedError(RuntimeError):
    """Admission control rejected a request. ``reason`` is "queue_full"
    (bounded scheduler queue at capacity) or "memory" (estimated token
    demand over budget)."""

    def __init__(self, reason: str):
        super().__init__(f"request shed: {reason}")
        self.reason = reason


@dataclass
class ServerConfig:
    """Front-end policy knobs (the engine's own config is orthogonal).

    ``max_queue`` is applied to the engine's scheduler if it doesn't
    already bound its queue. ``max_demand_factor`` scales the memory
    budget: outstanding token demand (queued + live) may reach that
    multiple of ``backend.token_capacity()`` — above it, new work is
    shed with reason "memory" rather than queued into unbounded wait.
    """

    max_queue: int = 32
    max_demand_factor: float = 4.0
    max_retries: int = 2
    retry_backoff_s: float = 0.05
    # Pump sleep when the engine has nothing to do (keeps the loop
    # responsive to new submissions without spinning).
    idle_sleep_s: float = 0.002
    watchdog_stall_s: float = 30.0
    # Defaults applied to requests that don't set their own deadlines
    # (None = no deadline).
    default_ttft_deadline_s: Optional[float] = None
    default_deadline_s: Optional[float] = None
    # Observability: None = no HTTP endpoints; 0 = bind an ephemeral
    # port (read it back from ``srv.metrics_addr``).
    metrics_port: Optional[int] = None
    metrics_host: str = "127.0.0.1"
    # Where watchdog/pump-crash flight-recorder dumps are written as
    # JSON (one file per dump); None keeps them in memory only.
    dump_dir: Optional[str] = None


class AsyncServer:
    """Asyncio front end: submit/stream/cancel over one ``ServeEngine``.

    Use as an async context manager (starts/stops the pump task)::

        async with AsyncServer(engine) as srv:
            async for tok in srv.generate([1, 2, 3], max_new_tokens=8):
                ...

    or ``start()`` / ``stop()`` explicitly. All methods must be called
    from the event loop thread — the engine itself is never shared
    across threads.
    """

    def __init__(self, engine, config: Optional[ServerConfig] = None,
                 metrics: Optional[ServeMetrics] = None):
        self.eng = engine
        self.config = config or ServerConfig()
        self.metrics = metrics or ServeMetrics()
        self.watchdog = Watchdog(
            self.config.watchdog_stall_s, on_stall=self._on_stall,
        )
        if self.eng.sched.max_queue is None:
            self.eng.sched.max_queue = self.config.max_queue
        # id(req) -> stream queue; Requests are mutable dataclasses
        # (unhashable), and identity is exactly the lifetime we track.
        self._streams: Dict[int, asyncio.Queue] = {}
        self._open: Dict[int, Request] = {}
        self._pump_task: Optional[asyncio.Task] = None
        self._running = False
        self._crashed = False
        self._wake = asyncio.Event()  # submission -> pump wakes instantly
        self._http_server: Optional[asyncio.AbstractServer] = None
        self.metrics_addr: Optional[tuple] = None  # (host, port) once bound

    # -- observability hooks -----------------------------------------------

    def _on_stall(self, stalled_for: float):
        """Watchdog callback: count + record the stall duration, and
        freeze the engine's flight recorder for the post-mortem."""
        self.metrics.inc("watchdog_stalls")
        self.metrics.observe("watchdog_stall_s", stalled_for)
        self._dump_recorder("watchdog_stall")

    def _dump_recorder(self, reason: str) -> Optional[dict]:
        rec = getattr(self.eng, "recorder", None)
        if rec is None:
            return None
        path = None
        if self.config.dump_dir is not None:
            path = os.path.join(
                self.config.dump_dir,
                f"flight_{reason}_{rec.dumps}.json",
            )
        return rec.dump(reason, path=path)

    # -- lifecycle ---------------------------------------------------------

    async def start(self):
        assert self._pump_task is None, "server already started"
        self._running = True
        self._pump_task = asyncio.create_task(self._pump())
        if self.config.metrics_port is not None:
            await self.start_metrics_server()

    async def start_metrics_server(self, host: Optional[str] = None,
                                   port: Optional[int] = None) -> int:
        """Bind the /metrics + /healthz HTTP listener; returns the bound
        port (useful with port 0). Idempotent per server instance."""
        assert self._http_server is None, "metrics server already bound"
        host = host if host is not None else self.config.metrics_host
        port = port if port is not None else self.config.metrics_port or 0
        self._http_server = await asyncio.start_server(
            self._handle_http, host, port
        )
        bound = self._http_server.sockets[0].getsockname()[1]
        self.metrics_addr = (host, bound)
        return bound

    async def stop(self):
        """Stop the pump; any still-open request is cancelled (its
        resources free through the engine's normal cancel path)."""
        self._running = False
        self._wake.set()
        if self._pump_task is not None:
            await self._pump_task
            self._pump_task = None
        for req in list(self._open.values()):
            self.eng.cancel(req)
            self.metrics.inc("cancellations_shutdown")
        self._finalize_done()
        if self._http_server is not None:
            self._http_server.close()
            await self._http_server.wait_closed()
            self._http_server = None

    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, *exc):
        await self.stop()

    # -- admission ---------------------------------------------------------

    def _outstanding_tokens(self) -> int:
        sched = self.eng.sched
        return (
            sum(len(r.prompt) + r.max_new_tokens for r in sched.queue)
            + sum(len(e.req.prompt) + e.req.max_new_tokens
                  for e in sched.live.values())
        )

    def _try_submit(self, req: Request):
        demand = len(req.prompt) + req.max_new_tokens
        budget = (self.config.max_demand_factor
                  * self.eng.backend.token_capacity())
        if self._outstanding_tokens() + demand > budget:
            raise ShedError("memory")
        try:
            self.eng.submit(req)
        except QueueFull:
            raise ShedError("queue_full") from None

    def _register(self, req: Request) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        self._streams[id(req)] = q
        self._open[id(req)] = req

        def on_token(r: Request, tok: int):
            q.put_nowait(tok)

        req.on_token = on_token
        return q

    def _finalize(self, req: Request):
        """Close a request's stream (idempotent)."""
        q = self._streams.pop(id(req), None)
        self._open.pop(id(req), None)
        if q is not None:
            q.put_nowait(_DONE)

    async def submit(self, prompt: List[int], max_new_tokens: int = 16,
                     sampling: SamplingParams = GREEDY,
                     ttft_deadline_s: Optional[float] = None,
                     deadline_s: Optional[float] = None) -> Request:
        """Admit a request (retrying sheds with backoff) and return it.
        Raises ``ShedError`` — with the request finalized as
        finish_reason="shed" — if every attempt was rejected."""
        cfg = self.config
        req = Request(
            prompt=list(prompt), max_new_tokens=max_new_tokens,
            sampling=sampling,
            ttft_deadline_s=(ttft_deadline_s if ttft_deadline_s is not None
                             else cfg.default_ttft_deadline_s),
            deadline_s=(deadline_s if deadline_s is not None
                        else cfg.default_deadline_s),
        )
        self._register(req)
        t0 = time.perf_counter()
        attempt = 0
        while True:
            try:
                self._try_submit(req)
                self.metrics.inc("submitted")
                self._wake.set()
                return req
            except ShedError as e:
                if attempt >= cfg.max_retries or self._past_deadline(req, t0):
                    req.done = True
                    req.finish_reason = "shed"
                    req.t_done = time.perf_counter()
                    tracer = getattr(self.eng, "tracer", None)
                    if tracer is not None:  # shed never reached submit;
                        tracer.shed(req)    # open+close its timeline here
                    self.metrics.inc("sheds")
                    self.metrics.inc(f"shed_{e.reason}")
                    self._finalize(req)
                    raise
                self.metrics.inc("shed_retries")
                await asyncio.sleep(cfg.retry_backoff_s * (2 ** attempt))
                attempt += 1

    @staticmethod
    def _past_deadline(req: Request, t0: float) -> bool:
        if req.deadline_s is None:
            return False
        return time.perf_counter() - t0 >= req.deadline_s

    # -- streaming ---------------------------------------------------------

    async def stream(self, req: Request) -> AsyncIterator[int]:
        """Yield `req`'s tokens as the engine emits them; ends when the
        request reaches ANY terminal state. Abandoning the iterator
        (break / task cancellation) cancels the request, freeing its
        row within one engine tick."""
        q = self._streams.get(id(req))
        if q is None:  # already finalized — replay nothing
            return
        try:
            while True:
                item = await q.get()
                if item is _DONE:
                    return
                yield item
        finally:
            if not req.done:
                self.cancel(req)

    async def generate(self, prompt: List[int], max_new_tokens: int = 16,
                       sampling: SamplingParams = GREEDY,
                       ttft_deadline_s: Optional[float] = None,
                       deadline_s: Optional[float] = None
                       ) -> AsyncIterator[int]:
        """submit + stream in one call."""
        req = await self.submit(
            prompt, max_new_tokens=max_new_tokens, sampling=sampling,
            ttft_deadline_s=ttft_deadline_s, deadline_s=deadline_s,
        )
        async for tok in self.stream(req):
            yield tok

    async def complete(self, prompt: List[int], max_new_tokens: int = 16,
                       sampling: SamplingParams = GREEDY,
                       ttft_deadline_s: Optional[float] = None,
                       deadline_s: Optional[float] = None) -> Request:
        """Non-streaming convenience: run to a terminal state, return
        the finished Request (`.out`, `.finish_reason`)."""
        req = await self.submit(
            prompt, max_new_tokens=max_new_tokens, sampling=sampling,
            ttft_deadline_s=ttft_deadline_s, deadline_s=deadline_s,
        )
        async for _ in self.stream(req):
            pass
        return req

    def cancel(self, req: Request) -> bool:
        """Client cancellation: frees the request's slot/blocks/pending
        speculative state within one engine tick (immediately if live).
        Safe to call at any time; False if it already finished."""
        hit = self.eng.cancel(req)
        if hit:
            self.metrics.inc("client_cancellations")
        self._finalize(req)
        return hit

    # -- pump --------------------------------------------------------------

    def _finalize_done(self) -> int:
        """Close streams of requests that reached a terminal state and
        record their latency metrics. Returns how many closed."""
        done = [r for r in self._open.values() if r.done]
        for req in done:
            reason = req.finish_reason or "unknown"
            self.metrics.inc(f"finish_{reason}")
            if reason in ("eos", "length", "cache_ceiling"):
                self.metrics.inc("completed")
            if req.t_admitted:
                self.metrics.observe(
                    "queue_time_s", req.t_admitted - req.t_submit)
            if req.t_first_token:
                self.metrics.observe(
                    "ttft_s", req.t_first_token - req.t_submit)
            if req.t_done:
                self.metrics.observe(
                    "latency_s", req.t_done - req.t_submit)
            self._finalize(req)
        return len(done)

    async def _pump(self):
        """The single engine-driving task: step while work is pending,
        close finished streams, feed the watchdog, sleep when idle."""
        try:
            while self._running:
                if self.eng.sched.pending():
                    emitted = self.eng.step()
                    closed = self._finalize_done()
                    self.watchdog.beat(emitted > 0 or closed > 0,
                                       self.eng.sched.pending())
                    # Yield so submit()/cancel() callers interleave.
                    await asyncio.sleep(0)
                else:
                    self._finalize_done()
                    self.watchdog.beat(False, False)
                    self._wake.clear()
                    try:
                        await asyncio.wait_for(
                            self._wake.wait(), self.config.idle_sleep_s)
                    except asyncio.TimeoutError:
                        pass
        except Exception:
            # Engine crash: never strand consumers — every open request
            # terminates with finish_reason="error" and its stream ends.
            # The flight recorder (if any) freezes the last ticks for
            # the post-mortem.
            self._crashed = True
            self._dump_recorder("pump_crash")
            for req in list(self._open.values()):
                if not req.done:
                    req.done = True
                    req.finish_reason = "error"
                    req.t_done = time.perf_counter()
                self.metrics.inc("finish_error")
                self._finalize(req)
            raise

    # -- introspection -----------------------------------------------------

    def _collect_telemetry_gauges(self):
        """Pull the engine's model-interior telemetry (routing health +
        numerics, serve/telemetry.py) and roofline-vs-measured program
        efficiency into labeled gauges. No-ops unless the engine was
        built with telemetry=True."""
        agg = getattr(self.eng, "telemetry", None)
        if agg is not None:
            self.metrics.merge_gauges(agg.gauges())
        eff = getattr(self.eng, "program_efficiency", None)
        if eff is not None:
            for program, ratio in (eff() or {}).items():
                self.metrics.set_gauge(
                    "program_efficiency", ratio, program=program)

    def snapshot(self) -> dict:
        """Server metrics + engine robustness counters + watchdog, as
        one flat dict."""
        collect_engine_metrics(self.eng, self.metrics)
        self.metrics.counters["watchdog_stalls"] = self.watchdog.stalls
        self._collect_telemetry_gauges()
        return self.metrics.snapshot()

    def metrics_text(self) -> str:
        """The /metrics body: a fresh Prometheus text exposition of the
        full metrics surface + the frozen engine-config info gauge."""
        collect_engine_metrics(self.eng, self.metrics)
        self.metrics.counters["watchdog_stalls"] = self.watchdog.stalls
        self._collect_telemetry_gauges()
        info = None
        if hasattr(self.eng, "config_info"):
            info = self.eng.config_info()
        return render_prometheus(self.metrics, info=info)

    def health(self) -> dict:
        """The /healthz body. status "ok" while the pump is alive;
        "crashed" (HTTP 503) once it died on an engine exception."""
        pump_alive = (self._pump_task is not None
                      and not self._pump_task.done())
        status = "crashed" if self._crashed else (
            "ok" if pump_alive or not self._running else "stopped"
        )
        return {
            "status": status,
            "pump_alive": pump_alive,
            "queued": len(self.eng.sched.queue),
            "live": len(self.eng.sched.live),
            "open_streams": len(self._open),
            "watchdog_stalls": self.watchdog.stalls,
        }

    # -- HTTP endpoints ----------------------------------------------------

    async def _handle_http(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        """Minimal HTTP/1.1 responder for pull-based scraping — GET
        /metrics and /healthz only, one request per connection (the
        scrape pattern; no keep-alive, no external deps)."""
        try:
            request_line = await reader.readline()
            parts = request_line.decode("latin-1", "replace").split()
            path = parts[1] if len(parts) >= 2 else "/"
            while True:  # drain headers
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            route = path.split("?", 1)[0]
            if route == "/metrics":
                status, ctype = 200, CONTENT_TYPE
                body = self.metrics_text()
            elif route == "/healthz":
                h = self.health()
                status = 200 if h["status"] == "ok" else 503
                ctype = "application/json"
                body = json.dumps(h) + "\n"
            else:
                status, ctype = 404, "text/plain; charset=utf-8"
                body = "not found\n"
            data = body.encode("utf-8")
            phrase = {200: "OK", 404: "Not Found",
                      503: "Service Unavailable"}[status]
            writer.write(
                (f"HTTP/1.1 {status} {phrase}\r\n"
                 f"Content-Type: {ctype}\r\n"
                 f"Content-Length: {len(data)}\r\n"
                 "Connection: close\r\n\r\n").encode("latin-1") + data
            )
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass
