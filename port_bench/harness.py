"""One run of one cell: set-up, the measured window, the traced steps,
then the comparison with the plain reference.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: it names a
configuration (whose ``file`` holds its sizes) and a traffic mix
(``port_bench/traffic/<traffic>.json``); its limits for ``correct`` are in
``port_bench/cells/<cell>.json``; each metric it reports is read by
``port_bench/metrics/<metric up to its first dot>.py``. Nothing here names
a cell, a configuration or a metric.

Training cells: set-up makes the weights and the state, then runs the
checked steps (the traffic's ``checked_steps`` batches, through the same
step and feed as the window) and reads from the program's state what the
reference will be held to; the window continues the same state. Inference
cells: set-up makes the weights and warms the call on two batches; the
window keeps every answer, which is compared once it has closed.
"""
from __future__ import annotations

import gc
import importlib
import json
import sys
import time
from pathlib import Path

from . import compare, flops, program, traffic, weights
from .reference import module_of
from .reference import train as ref_train
from .trace import WINDOW, Ranges, events_of, reduce_trace

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its files, found by name."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
        self.name, self.entry = name, cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(root / configs[self.entry["config"]]["file"])
        here = root / "port_bench"
        self.traffic = load_json(here / "traffic"
                                 / f"{self.entry['traffic']}.json")
        limits = here / "cells" / f"{name}.json"
        self.limits = load_json(limits)["limits"] if limits.exists() else {}
        self.units = {m["name"]: m["unit"]
                      for m in bench["end_to_end"] + bench["per_layer"]}
        self.end_to_end = [m["name"] for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m["name"] for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and ("workloads" in m
                               or m["moves"] in self.end_to_end)]


def reader(metric: str):
    return importlib.import_module(
        f"port_bench.metrics.{metric.split('.')[0]}")


def _path(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_train_readout(cfg, spec, flat, state, step, ring, seed, checked,
                          b1):
    """Runs the checked steps; returns (state, the program's readout)."""
    import torch

    losses, tel, grads = [], None, None
    for k in range(checked):
        state, metrics = step(state, ring[k])
        losses.append(metrics["total_loss"])
        if k == 0:
            mu = state["opt"]["mu"]
            grads = torch.stack([_path(mu, p).norm() for p, _, _ in spec]) \
                / (1 - b1)
            tel = metrics.get("telemetry")
    readout = {"losses": [float(x) for x in losses],
               "grad_norms": grads.cpu(),
               "change_norms": weights.change_norms(spec, flat, seed).cpu(),
               "telemetry": tel}
    return state, readout


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, cfg_override=None, traffic_override=None) -> dict:
    """One run; returns the result line as a dict."""
    import torch

    device = torch.device(device)
    cfg = cfg_override or cell.config
    tr = traffic_override or cell.traffic
    model = module_of(cfg)
    spec = model.param_spec(cfg)
    pcfg = program.port_config(cfg)
    if cfg_override is None:
        from repro_torch.configs import get_config

        if pcfg != get_config(cfg["program"]):
            raise ValueError(f"{cfg['program']}: the configuration file's "
                             "sizes are not the port's configuration")
    train = tr["mode"] == "train"
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()  # the allocator's stats exist once CUDA is up
        torch.cuda.reset_peak_memory_stats(device)

    # --- set-up ------------------------------------------------------------
    flat = weights.make(spec, seed, device)
    params = program.params_tree(spec, flat)
    ring = traffic.make_ring(cfg, tr, seed, device)
    checked = tr.get("checked_steps", 3)
    if train:
        state = program.init_state(params)
        step = program.make_train_step(cfg, pcfg, tr)
        state, prog_readout = program_train_readout(
            cfg, spec, flat, state, step, ring, seed, checked,
            tr["optimizer"]["b1"])
        del params

        def one(i):
            _, metrics = step(state, ring[i % len(ring)])
            return metrics["total_loss"]
        first = checked
    else:
        infer = program.make_infer(pcfg)
        answers, latencies = [], []

        def one(i):
            idx = i % len(ring)
            t0 = time.perf_counter()
            logits = infer(params, ring[idx]["patches"])
            top5 = logits.topk(5, dim=-1).indices.cpu()
            latencies.append((time.perf_counter() - t0) * 1e3)
            answers.append((idx, logits, top5))
            return logits
        first = 0
        with torch.inference_mode():
            for i in range(2):  # warm-up: every shape the window uses
                one(i)
        answers.clear()
        latencies.clear()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"[bench] {cell.name} seed {seed}: set-up {setup_s:.3f} s")

    # --- the window (its first traced steps under the profiler) -----------
    wraps = [w for m in cell.per_layer for w in getattr(reader(m), "WRAPS",
                                                         [])]
    outputs, trace_out, bounds = [], None, {}
    n_traced = tr.get("trace_steps", 0) if trace else 0
    mode = torch.inference_mode() if not train else torch.enable_grad()
    with mode:
        i = first
        t0 = time.perf_counter()
        if n_traced:
            from torch.profiler import ProfilerActivity, profile, \
                record_function

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with profile(activities=acts) as prof:
                with Ranges(wraps) as ranges, record_function(WINDOW):
                    for _ in range(n_traced):
                        outputs.append(one(i))
                        i += 1
                    _sync(device)
            bounds = ranges.bounds
        while time.perf_counter() - t0 < seconds:
            outputs.append(one(i))
            i += 1
        _sync(device)
        t1 = time.perf_counter()
    steps = i - first
    window = {"seconds": t1 - t0, "steps": steps,
              "latencies_ms": [] if train else latencies}
    log(f"[bench] window {window['seconds']:.3f} s, {steps} steps")
    if n_traced:
        cpu_ev, dev_ev = events_of(prof)
        del prof
        trace_out = reduce_trace(cpu_ev, dev_ev)
        log(f"[bench] trace: {trace_out['device_ops_n']} device ops, "
            f"{trace_out['attributed']} charged to ranges, "
            f"{len(bounds)} range calls")
    failed = sum(int(not torch.isfinite(x).all()) for x in outputs)
    del outputs
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # --- free the program's state, then the reference ---------------------
    if train:
        del state, step, one
    else:
        del params, infer, one
    del flat
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if train:
        ref = ref_train.train_readout(
            model, cfg, spec, tr["optimizer"], seed, ring[:checked], device,
            telemetry=tr.get("telemetry", False))
        numbers = compare.train_numbers(prog_readout, ref)
        left = int((~compare.moved(ref["grad_norms"])).sum())
        log(f"[bench] update_norm_gap leaves left out: {left} of "
            f"{len(spec)}")
    else:
        ref = ref_train.infer_logits(model, cfg, spec, seed,
                                     [b["patches"] for b in ring], device)
        numbers = compare.infer_numbers(answers, ref)
    log(f"[bench] reference {time.perf_counter() - t_ref:.3f} s")
    correct, checks = compare.judge(numbers, cell.limits)

    # --- the result line ----------------------------------------------------
    # device metrics come from the card's trace alone: never from a CPU run
    on_card = trace_out if device.type == "cuda" else None
    ctx = {"setup_s": setup_s, "window": window, "traffic": tr,
           "config": cfg, "trace": on_card, "bounds": bounds,
           "flops_per_step": flops.step_flops(cfg, tr),
           "steps_traced": n_traced}
    metrics = {}
    for name in (cell.per_layer if trace else cell.end_to_end):
        value = reader(name).read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": cell.units[name]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": steps, "failed": failed,
              "metrics": metrics, "device": dev}
    if on_card is not None:
        dev["busy_s"] = trace_out["busy_s"]
        dev["window_s"] = trace_out["window_s"]
        result["breakdown"] = {"device_ops": trace_out["device_ops"],
                               "idle_gaps": trace_out["idle_gaps"]}
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    """Top-level module names of JAX or the JAX package that are loaded."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))
