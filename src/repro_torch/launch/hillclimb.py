"""Perf hillclimb loop, counterpart of ``repro/launch/hillclimb.py``:
run a named list of (cell × sharding-variant) combinations through the
dry-run (``launch/dryrun.py``), appending tagged results to ``OUT``.
Each variant encodes one hypothesis; the roofline deltas are the
measurements. Host only: the dry-run runs on meta tensors.

Usage: ``python -m repro_torch.launch.hillclimb [tag ...]`` (every
variant not yet done when no tag is given).
"""
from __future__ import annotations

import json
import os
import sys
import traceback

from ..distributed.sharding import ShardingOptions
from .dryrun import run_cell

OUT = "results/perf_iterations_torch.jsonl"

# (tag, arch, shape, kwargs)
VARIANTS = [
    # --- cell 1: mamba2-370m:train_4k ------------------------------------
    # H1: 370M params can't feed a 16-wide TP axis; make the model axis
    # extra data parallelism (pure DP) — the gradient all-reduce against
    # the compute => compute-bound.
    ("mamba2_base", "mamba2-370m", "train_4k", {}),
    ("mamba2_pure_dp", "mamba2-370m", "train_4k",
     {"opts": ShardingOptions(tensor_parallel=False, expert_parallel=False),
      "dp_over_model": True}),
    # H2: + ZeRO-1 (grads reduce-scatter + one param gather, no per-layer
    # FSDP gathers)
    ("mamba2_pure_dp_zero1", "mamba2-370m", "train_4k",
     {"opts": ShardingOptions(tensor_parallel=False, expert_parallel=False),
      "dp_over_model": True, "zero1": True}),
    # --- cell 2: qwen2-72b:train_4k (flagship) -----------------------------
    # H3: FSDP re-gathers the weights every step; ZeRO-1 replaces that
    # with one grad RS + one param AG per step.
    ("qwen72b_base", "qwen2-72b", "train_4k", {}),
    ("qwen72b_zero1", "qwen2-72b", "train_4k", {"zero1": True}),
    # H4: microbatching with ZeRO-1 (activation collectives shrink per
    # microbatch; params gathered once regardless).
    ("qwen72b_zero1_mb4", "qwen2-72b", "train_4k",
     {"zero1": True, "microbatches": 4}),
    # --- cell 3: deepseek-v2-lite:train_4k (paper-representative MoE
    # routing) ----------------------------------------------------------
    # H5: token routing under expert parallelism gathers the routed
    # buffers per layer per pass. With experts replicated (EP off; FSDP
    # shards them), routing is device-local.
    ("deepseek_base", "deepseek-v2-lite-16b", "train_4k", {}),
    ("deepseek_no_ep", "deepseek-v2-lite-16b", "train_4k",
     {"opts": ShardingOptions(expert_parallel=False)}),
    ("deepseek_no_ep_zero1", "deepseek-v2-lite-16b", "train_4k",
     {"opts": ShardingOptions(expert_parallel=False), "zero1": True}),
    # H6: the paper's router at the same station — Soft MoE has no
    # scatter/top-k at all; dispatch/combine are dense einsums that
    # shard cleanly (slots over model).
    ("deepseek_soft_base", "deepseek-v2-lite-16b+soft", "train_4k", {}),
    # H7: the Soft-MoE weight/slot tensors slot-replicated (gather the
    # small axis) instead of an output all-reduce. Runs with EP on.
    ("deepseek_soft_slotrep", "deepseek-v2-lite-16b+soft", "train_4k", {}),
    ("deepseek_soft_slotrep_zero1", "deepseek-v2-lite-16b+soft", "train_4k",
     {"zero1": True}),
    ("deepseek_soft_no_ep_zero1", "deepseek-v2-lite-16b+soft", "train_4k",
     {"opts": ShardingOptions(expert_parallel=False), "zero1": True}),
    # qwen2-0.5b: pure DP like mamba2
    ("qwen05b_pure_dp_zero1", "qwen2-0.5b", "train_4k",
     {"opts": ShardingOptions(tensor_parallel=False, expert_parallel=False),
      "dp_over_model": True, "zero1": True}),
]


def main(names=None):
    names = names or sys.argv[1:] or [v[0] for v in VARIANTS]
    done = set()
    if os.path.exists(OUT):
        with open(OUT) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") == "ok":
                        done.add(r.get("tag"))
                except json.JSONDecodeError:
                    pass
    os.makedirs(os.path.dirname(OUT) or ".", exist_ok=True)
    for tag, arch, shape, kw in VARIANTS:
        if tag not in names or tag in done:
            continue
        print(f"### {tag}", flush=True)
        try:
            r = run_cell(arch, shape, **kw)
        except Exception as e:  # a variant failure is recorded, not fatal
            traceback.print_exc()
            r = {"cell": f"{arch}:{shape}", "status": "error",
                 "error": f"{type(e).__name__}: {e}"}
        r["tag"] = tag
        with open(OUT, "a") as f:
            f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
