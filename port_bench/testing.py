"""Tiny sizes of the benchmark's configurations and traffic, for the CPU
tests: the same families, files and code paths at a size a test run
holds. The program computes in f32 here (``dtype``), so it meets the
reference to rounding and every planted fault stands out."""
from __future__ import annotations

import sys
import time

from .harness import ROOT, Cell, load_json, run

if str(ROOT / "src") not in sys.path:  # the port, as run.py finds it
    sys.path.insert(0, str(ROOT / "src"))

TINY_CONFIG = {
    "vit": dict(num_patches=16, patch_dim=48, num_classes=10, num_layers=2,
                d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
                d_ff=64, moe_layers=[1], num_experts=4, expert_d_ff=64),
    "lm": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
               head_dim=16, d_ff=32, vocab_size=256, moe_layers=[0, 1],
               num_experts=4, expert_d_ff=32),
}
TINY_TRAFFIC = {"batch": 4, "ring": 4, "trace_steps": 1, "seq_len": 32}


def tiny(cell: Cell, dtype: str = "float32"):
    """(configuration, traffic) of ``cell`` at the tiny size."""
    cfg = dict(cell.config, **TINY_CONFIG[cell.config["family"]],
               dtype=dtype)
    tr = dict(cell.traffic, **TINY_TRAFFIC)
    if cfg["family"] != "lm":
        tr.pop("seq_len")
    return cfg, tr


def tiny_run(name: str, seed: int = 2**31 + 11, trace: bool = False,
             root=ROOT, dtype: str = "float32"):
    """One run of cell ``name`` on the CPU at the tiny size: no window for
    a training cell (its checked steps are in set-up), a short one for an
    inference cell."""
    cell = Cell(name, root)
    cfg, tr = tiny(cell, dtype)
    seconds = 0.0 if tr["mode"] == "train" else 0.2
    return run(cell, seed, seconds, trace, "cpu", time.perf_counter(),
               cfg_override=cfg, traffic_override=tr)


def cell_names(root=ROOT):
    return [w["name"] for w in load_json(root / "BENCHMARK.json")["workloads"]]
