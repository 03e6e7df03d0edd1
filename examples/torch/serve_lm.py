"""Serve a small LM through the port's continuous-batching engine, twin
of ``examples/serve_lm.py``.

  PYTHONPATH=src python examples/torch/serve_lm.py --arch qwen2-0.5b --requests 6
  python examples/torch/serve_lm.py --paged --block-size 16 \
      --shared-prefix 32          # paged backend + radix prefix cache
  python examples/torch/serve_lm.py --paged --spec-k 4 \
      --max-new 32                # n-gram speculative decoding
  python examples/torch/serve_lm.py --device cpu   # the plain path

Uses the reduced config (random weights — this demonstrates the serving
machinery): requests with mixed prompt lengths, token budgets, and
per-request sampling params stream through the slot pool; chunked prefill
interleaves with decode; rows retire the step they finish and the next
queued request takes the slot immediately. Tokens stream via the
``Request.on_token`` callback as they are sampled. On the card the paged
backend decodes through the paged decode-attention kernel (K7);
``--no-kernel`` takes the gather path instead."""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.layers.common import resolve_device  # noqa: E402
from repro_torch.models import lm_init  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Request,
    SamplingParams,
    ServeEngine,
    SpecConfig,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--stream", action="store_true",
                    help="print each token as it is sampled")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged block-manager backend")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (paged backend)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="total pool blocks (default: contiguous parity)")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="radix-tree prefix sharing (paged; default on)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared system-prompt tokens "
                         "to every request (exercises the radix cache)")
    ap.add_argument("--no-kernel", dest="use_kernel", action="store_false",
                    default=True,
                    help="paged decode via the row-view gather oracle "
                         "instead of the paged decode-attention kernel")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft k tokens per verify "
                         "step via n-gram prompt lookup (0 = off)")
    ap.add_argument("--cache-generated", action="store_true",
                    help="also publish retired requests' generated tokens "
                         "into the radix prefix cache (paged backend)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(get_config(args.arch))
    print(f"serving {args.arch} (reduced: {cfg.num_layers}L "
          f"d={cfg.d_model}, vocab={cfg.vocab_size})")
    params = lm_init(torch.Generator(device=dev).manual_seed(0), cfg)
    kw = {}
    if args.paged:
        kw = dict(backend="paged", block_size=args.block_size,
                  num_blocks=args.num_blocks,
                  prefix_cache=args.prefix_cache,
                  use_kernel=args.use_kernel,
                  cache_generated=args.cache_generated)
        print(f"paged backend: block_size={args.block_size} "
              f"prefix_cache={args.prefix_cache} "
              f"cache_generated={args.cache_generated} "
              f"decode={'kernel' if args.use_kernel else 'gather'}")
    if args.spec_k > 0:
        kw["spec"] = SpecConfig(k=args.spec_k)
        print(f"speculative decoding: k={args.spec_k} (n-gram self-draft)")
    eng = ServeEngine(cfg, params, batch_size=args.batch, max_len=128,
                      device=dev, **kw)

    def stream(req, tok):
        print(f"  req[{req.sampling.seed}] += {tok}")

    gen = torch.Generator().manual_seed(1)
    shared = torch.randint(1, cfg.vocab_size, (args.shared_prefix,),
                           generator=torch.Generator().manual_seed(2))
    reqs = []
    for i in range(args.requests):
        prompt = shared.tolist() + torch.randint(
            1, cfg.vocab_size, (4 + i % 5,), generator=gen).tolist()
        req = Request(
            prompt=prompt,
            max_new_tokens=args.max_new,
            sampling=SamplingParams(
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, seed=i,
            ),
            on_token=stream if args.stream else None,
        )
        reqs.append(req)
        eng.submit(req)

    t0 = time.perf_counter()
    steps = eng.run()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in reqs)
    for i, r in enumerate(reqs):
        # finish_reason: "cache_ceiling" marks a TRUNCATED response (the
        # request hit max_len), distinct from a normal eos/length stop.
        print(f"req {i}: prompt[{len(r.prompt)}] -> {r.out} "
              f"[{r.finish_reason}]")
    truncated = sum(r.finish_reason == "cache_ceiling" for r in reqs)
    print(f"{args.requests} requests ({truncated} truncated at the cache "
          f"ceiling), {steps} decode steps, "
          f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s on {dev.type})")
    out = {"outputs": [list(r.out) for r in reqs],
           "finish_reasons": [r.finish_reason for r in reqs],
           "done": [r.done for r in reqs], "steps": steps,
           "tokens": total_tokens, "seconds": dt}
    stats = eng.spec_stats()
    if stats is not None:
        out["spec"] = stats
        print(f"spec decode: acceptance {stats['acceptance_rate']:.2f} "
              f"({stats['accepted']}/{stats['drafted']} drafts), "
              f"{stats['calls_per_token']:.2f} batched model calls/token")
    if args.paged:
        out["peak_cache_bytes"] = eng.peak_cache_bytes()
        print(f"peak cache {eng.peak_cache_bytes()/1e6:.2f}MB "
              f"(live high-water {eng.backend.live_block_hw} blocks; "
              f"pool high-water {eng.backend.mgr.high_water})")
        if eng.backend.prefix is not None:
            out["prefix_hits"] = eng.backend.prefix.hits
            print(f"prefix cache: {eng.backend.prefix.hits} block hits, "
                  f"{eng.backend.prefix.misses} cold lookups")
    return out


if __name__ == "__main__":
    main()
