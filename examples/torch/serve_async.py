"""Serve through the port's fault-tolerant asyncio front end, twin of
``examples/serve_async.py``.

  PYTHONPATH=src python examples/torch/serve_async.py --requests 8
  python examples/torch/serve_async.py --overload \
      --max-queue 4               # shed + retry under a burst
  python examples/torch/serve_async.py --deadline-ms 50 \
      --cancel-after 3            # deadlines + mid-stream cancellation
  python examples/torch/serve_async.py --trace \
      --metrics-port 0            # span timelines + /metrics scrape
  python examples/torch/serve_async.py --device cpu   # the plain path

Random weights (reduced config) — this demonstrates the serving-policy
machinery, not text quality: concurrent clients stream tokens through
``AsyncServer`` async generators while the engine batches them under
the hood; admission control sheds (with retry/backoff) when the bounded
queue or memory budget overflows; deadlines and client cancellations
free every row resource within one engine tick. The final metric
snapshot prints the counters the chaos harness asserts on.

``--trace`` turns on the host-side span tracer + flight recorder
(serve/tracing.py) and prints each request's timeline plus a text
Gantt; ``--metrics-port`` binds the Prometheus /metrics + /healthz
endpoints on localhost (0 = pick an ephemeral port) and scrapes
/metrics once at the end; ``--telemetry`` runs the model-interior
telemetry variants (serve/telemetry.py) and prints the per-layer
routing-health table plus the roofline-vs-measured program-efficiency
gauges (try ``--arch granite-moe-1b-a400m`` for the MoE stats). The
engine runs on the card unless ``--device cpu`` is given; with
``--paged`` it decodes through the paged decode-attention kernel."""
import argparse
import asyncio
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.layers.common import resolve_device  # noqa: E402
from repro_torch.models import lm_init  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AsyncServer,
    ServeEngine,
    ServerConfig,
    ShedError,
    render_timeline,
    timeline,
)


async def client(srv, i, args, reqs, streams):
    prompt = [1 + i, 2 + i, 3 + i]
    toks = []
    try:
        req = await srv.submit(
            prompt, max_new_tokens=args.max_new,
            deadline_s=(args.deadline_ms / 1e3 if args.deadline_ms else None),
        )
    except ShedError as e:
        print(f"[req {i}] shed ({e.reason})")
        streams[i] = ("shed", e.reason)
        return
    reqs.append(req)
    n = 0
    async for tok in srv.stream(req):
        toks.append(tok)
        n += 1
        if args.cancel_after and n >= args.cancel_after:
            break  # abandoning the stream cancels the request
    print(f"[req {i}] {toks}")
    streams[i] = ("streamed", toks)


async def scrape(addr, path="/metrics"):
    """One GET against the server's observability listener."""
    reader, writer = await asyncio.open_connection(*addr)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: _\r\n\r\n".encode("ascii"))
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return raw.decode("utf-8").split("\r\n\r\n", 1)[1]


def print_timelines(reqs):
    print("\nper-request timelines:")
    print(f"  {'req':>3} {'reason':<13} {'tok':>3} {'queue_ms':>8} "
          f"{'ttft_ms':>8} {'total_ms':>8} {'spans':>5}")
    for i, req in enumerate(reqs):
        tl = timeline(req)

        def ms(key):
            v = tl.get(key)
            return f"{v * 1e3:8.1f}" if v is not None else f"{'-':>8}"
        print(f"  {i:>3} {tl['finish_reason'] or '?':<13} "
              f"{tl['n_tokens']:>3} {ms('queue_s')} {ms('ttft_s')} "
              f"{ms('total_s')} {tl['n_spans']:>5}")
    print()
    print(render_timeline(reqs))


def print_telemetry(eng):
    """Per-layer routing-health table + program-efficiency gauges, from
    the device-side stats the telemetry program variants emit."""
    snap = eng.telemetry_snapshot()
    for phase in sorted(snap):
        flat = snap[phase]
        # moe_l<idx>_<stat> -> {layer: {stat: value}}
        layers = {}
        rest = {}
        for k, v in sorted(flat.items()):
            if k.startswith("moe_l"):
                lid, stat = k[len("moe_l"):].split("_", 1)
                layers.setdefault(int(lid), {})[stat] = v
            else:
                rest[k] = v
        print(f"\nmodel-interior telemetry [{phase}]:")
        if layers:
            stats = sorted({s for d in layers.values() for s in d})
            head = " ".join(f"{s[:16]:>16}" for s in stats)
            print(f"  {'layer':>5} {head}")
            for lid in sorted(layers):
                row = " ".join(f"{layers[lid].get(s, float('nan')):16.4g}"
                               for s in stats)
                print(f"  {lid:>5} {row}")
        for k, v in rest.items():
            print(f"  {k}: {v:.6g}")
    eff = eng.program_efficiency()
    if eff:
        print("\nroofline-vs-measured program efficiency "
              "(bound / measured mean host wall; 1.0 = at the roofline "
              "bound on the card):")
        for program, ratio in sorted(eff.items()):
            print(f"  {program:>14}: {ratio:.3e}")
    return snap


async def run(args):
    dev = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    params = lm_init(torch.Generator(device=dev).manual_seed(0), cfg)
    eng = ServeEngine(
        cfg, params, batch_size=args.batch, max_len=64,
        backend="paged" if args.paged else "contiguous",
        trace=args.trace,
        flight_recorder=64 if args.trace else 0,
        telemetry=args.telemetry, device=dev,
    )
    scfg = ServerConfig(max_queue=args.max_queue,
                        metrics_port=args.metrics_port)
    if args.overload:
        # No retries and a tiny demand budget: the burst must shed.
        scfg.max_retries = 0
        scfg.max_demand_factor = 0.5
    reqs, streams = [], {}
    async with AsyncServer(eng, scfg) as srv:
        if srv.metrics_addr is not None:
            host, port = srv.metrics_addr
            print(f"metrics: http://{host}:{port}/metrics  "
                  f"healthz: http://{host}:{port}/healthz")
        await asyncio.gather(
            *(client(srv, i, args, reqs, streams)
              for i in range(args.requests))
        )
        prom = None
        if srv.metrics_addr is not None:
            prom = await scrape(srv.metrics_addr)
        snap = srv.snapshot()
    print("\nmetrics:")
    for k, v in snap.items():
        print(f"  {k}: {v}")
    out = {"streams": streams, "requests": reqs, "snapshot": snap,
           "metrics_text": prom}
    if args.trace:
        print_timelines(reqs)
        if eng.recorder is not None and eng.recorder.ticks:
            print("\nflight recorder (last ticks):")
            print(eng.recorder.render(6))
    if args.telemetry:
        out["telemetry"] = print_telemetry(eng)
    if prom is not None:
        head = prom.splitlines()[:12]
        print("\n/metrics scrape (first lines):")
        for line in head:
            print(f"  {line}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--overload", action="store_true",
                    help="shrink budgets so the burst load-sheds")
    ap.add_argument("--deadline-ms", type=float, default=0,
                    help="per-request total deadline")
    ap.add_argument("--cancel-after", type=int, default=0,
                    help="clients abandon their stream after N tokens")
    ap.add_argument("--trace", action="store_true",
                    help="per-request span timelines + flight recorder")
    ap.add_argument("--telemetry", action="store_true",
                    help="model-interior telemetry: per-layer routing "
                         "health + program-efficiency gauges")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="bind /metrics + /healthz (0 = ephemeral port)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return asyncio.run(run(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
