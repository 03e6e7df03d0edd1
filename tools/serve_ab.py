"""Serving times of the port from several source trees, on one card.

    python3 tools/serve_ab.py OLD NEW NEW OLD [--arch NAME ...]

Each positional argument is a checkout of this repository: its ``src/``
holds the ``repro_torch`` that the run serves from (a parent commit
unpacked with ``git archive`` into an ignored directory, or ``.``). The
trees run one after another, each in a process of its own, so that
``OLD NEW NEW OLD`` reads a before/after pair twice on the same card.

Each run serves each ``--arch`` (default: both sparse MoE archs) as
``chip_smoke.py``'s phases 12 and 13 do, with that script's helpers from
this checkout: full width, depth cut by ``SERVE_DEPTH``, random weights
from seed 0 (``serving_weights``), the paged engine at batch 8, max_len
2048, block 16, 8 requests of 16-256 prompt tokens and 16 new tokens
each, one warm-up run, then telemetry on and off. It prints one JSON line
a run and arch: the TTFT p50, the prefill-chunk p50 and the decode-step
p50 (host times, every call synchronised), tok/s and the greedy tokens'
digest (equal across trees when the change keeps the served tokens),
beside the card's name and power limit as ``nvidia-smi`` prints them.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-lite-16b")


def serve(tree: pathlib.Path, archs) -> None:
    """Serve ``archs`` from ``tree``'s port (this process only)."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import numpy as np
    import torch

    # the tree's package first: chip_smoke puts this checkout's src/ on
    # the path when it is imported, and its lazy imports then resolve
    # through the package already loaded
    import repro_torch
    from repro_torch.serve import ServeEngine

    import chip_smoke as cs

    if not pathlib.Path(repro_torch.__file__).is_relative_to(tree / "src"):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
    card = cs.phase_device(torch)
    geo = dict(batch_size=8, max_len=2048, block_size=16, device="cuda",
               backend="paged")
    for arch in archs:
        cfg = cs.serving_config(arch)
        params = cs.serving_weights(torch, cfg)
        prompts = cs.moe_serve_requests(np, cfg.vocab_size)
        warm = ServeEngine(cfg, params, telemetry=True, **geo)
        cs.run_engine(torch, warm, prompts[1:3], 4)
        del warm
        for telemetry in (True, False):
            eng = ServeEngine(cfg, params, telemetry=telemetry, **geo)
            chunk_s = cs.timed_method(torch, eng.backend, "prefill_chunk")
            reqs, wall, decode_s = cs.run_engine(torch, eng, prompts, 16)
            outs = json.dumps([r.out for r in reqs]).encode()
            print(json.dumps({
                "tree": str(tree), "card": card, "arch": arch,
                "depth": cfg.num_layers, "telemetry": telemetry,
                "ttft_p50_ms": statistics.median(
                    r.t_first_token - r.t_submit for r in reqs) * 1e3,
                "prefill_chunk_p50_ms": statistics.median(chunk_s) * 1e3,
                "prefill_chunks": len(chunk_s),
                "decode_p50_ms": statistics.median(decode_s) * 1e3,
                "decode_steps": len(decode_s),
                "tok_s": sum(len(r.out) for r in reqs) / wall,
                "tokens_sha1": hashlib.sha1(outs).hexdigest()[:12],
            }), flush=True)
            del eng
        del params
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", type=pathlib.Path)
    ap.add_argument("--arch", action="append", choices=ARCHS)
    ap.add_argument("--child", action="store_true",
                    help="serve from the one tree given, in this process")
    args = ap.parse_args(argv)
    archs = args.arch or ARCHS
    trees = [t.resolve() for t in args.trees]
    if args.child:
        serve(trees[0], archs)
        return 0
    rc = 0
    for i, tree in enumerate(trees):
        t0 = time.perf_counter()
        print(f"[serve_ab] run {i + 1} of {len(trees)}: {tree}", flush=True)
        cmd = [sys.executable, __file__, "--child", str(tree)]
        for a in archs:
            cmd += ["--arch", a]
        done = subprocess.run(cmd, cwd=ROOT)
        print(f"[serve_ab] run {i + 1}: exit {done.returncode} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rc = rc or done.returncode
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
