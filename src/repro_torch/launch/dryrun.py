"""Multi-pod dry-run, counterpart of ``repro/launch/dryrun.py``: run
every (architecture × input shape) cell's program on the production
meshes from one CPU process, and emit the memory per device, the
collectives and the roofline terms (compute / memory / collective) per
cell.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \\
      [--multi-pod] [--no-fsdp] [--out results.jsonl]
  python -m repro_torch.launch.dryrun --all [--multi-pod]  # every cell

Where the reference fakes 512 XLA devices and compiles the cell, the
port starts a fake process group of 256 ranks (16×16), or 512 with
``--multi-pod`` (2×16×16), builds the mesh over it, and runs the cell's
real program once, on meta tensors (``launch/specs.py``), as rank 0.
Nothing is allocated and no byte moves: the fake group completes every
collective at once. ``record_collectives`` records each collective the
program emits (``roofline/collectives.py``). The group is started
inside ``run_cell`` when none exists, never at import, and destroyed
when the cell ends.

What the JSON line holds, against the reference's keys:

  * ``memory.args_bytes_per_dev`` / ``output_bytes_per_dev``: exact, the
    bytes of this rank's shards of the arguments (placed by the cell's
    in-shardings) and of the outputs;
  * ``temp_bytes_per_dev``, ``cpu_f32_upcast_bytes``,
    ``tpu_corrected_temp_bytes`` and ``hlo_cost``: null. Eager torch has
    no buffer plan to read a temp peak from, no XLA-CPU upcast, and no
    compiled program to ask for a cost;
  * ``analytic``: ``roofline/flops.py``'s model per device;
  * ``collectives``: the recorded ops, by kind, ring-weighted, in-pod
    and pod-crossing;
  * ``roofline``: the three terms at the H100's data-sheet figures
    (``roofline/analysis.py``), the bottleneck and the fractions.

One CPU process runs these; cells are independent, so ``main``
writes one JSON line per cell and can resume (``--skip-done``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import ASSIGNED_NAMES, SHAPES, get_config, shape_supported
from ..distributed.api import use_mesh
from ..distributed.sharding import (
    ShardingOptions,
    distribute_tree,
    map_with_path,
)
from ..roofline.analysis import (
    HBM_BW,
    INTER_NODE_BW,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    model_flops,
)
from ..roofline.collectives import record_collectives
from ..roofline.flops import analytic_cost
from .mesh import make_production_mesh
from .specs import build_cell

POD_RANKS = 256  # one pod: a (data=16, model=16) mesh


def _bytes(t) -> int:
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def _tree_bytes(tree) -> int:
    total = 0

    def add(_, t):
        nonlocal total
        total += _bytes(t)
        return t

    map_with_path(add, tree)
    return total


def local_bytes(mesh, args, shardings) -> int:
    """Bytes of this rank's shards of ``args`` under ``shardings``: a
    placed leaf's local tensor, a plain leaf (the train batch) as its
    placements would cut it."""
    return sum(_tree_bytes(distribute_tree(mesh, a, sh))
               for a, sh in zip(args, shardings))


def _fake_group(world: int) -> bool:
    """Start a fake process group of ``world`` ranks (this process is rank
    0) unless a group exists; True if this call started it."""
    if dist.is_initialized():
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return True


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             opts: ShardingOptions | None = None, microbatches: int = 1,
             use_kernel: bool = False, dp_over_model: bool = False,
             zero1: bool = False, cfg_overrides: dict | None = None,
             verbose: bool = True) -> dict:
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    ok, reason = shape_supported(cfg, shape_name)
    if not ok:
        return {"cell": f"{arch}:{shape_name}", "status": "skipped",
                "reason": reason}
    started = _fake_group(2 * POD_RANKS if multi_pod else POD_RANKS)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        chips = mesh.size()
        t0 = time.time()
        with use_mesh(mesh, dp_over_model=dp_over_model):
            cell = build_cell(cfg, shape_name, mesh, opts,
                              microbatches=microbatches,
                              use_kernel=use_kernel, zero1=zero1)
            args_bytes = local_bytes(mesh, cell.args, cell.in_shardings)
            t_build = time.time() - t0
            with record_collectives(
                    POD_RANKS if multi_pod else None) as rec:
                out = cell.fn(*cell.args)
            t_run = time.time() - t0 - t_build
        out_bytes = _tree_bytes(out)
    finally:
        if started:
            dist.destroy_process_group()
    mc = rec.module

    shape = SHAPES[shape_name]
    an = analytic_cost(cfg, shape_name)
    flops_dev, bytes_dev = an.per_device(chips)
    coll_ici = mc.weighted_ici_bytes()
    coll_pod = mc.weighted_pod_bytes()

    t_compute = flops_dev / PEAK_FLOPS_BF16
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_ici / NVLINK_BW + coll_pod / INTER_NODE_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, shape.mode)

    result = {
        "cell": f"{arch}:{shape_name}",
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "status": "ok",
        "lower_s": round(t_build, 1),  # building and placing the cell
        "compile_s": None,  # eager: nothing compiles
        "run_s": round(t_run, 1),  # the program once, on meta tensors
        "memory": {
            "args_bytes_per_dev": args_bytes,
            "temp_bytes_per_dev": None,
            "cpu_f32_upcast_bytes": None,
            "tpu_corrected_temp_bytes": None,
            "output_bytes_per_dev": out_bytes,
        },
        "hlo_cost": None,
        "analytic": {
            "flops_per_dev": flops_dev,
            "bytes_per_dev": bytes_dev,
            "note": an.notes,
        },
        "collectives": {
            "by_kind_bytes": mc.by_kind(),
            "counts": mc.counts(),
            "ici_weighted_bytes": coll_ici,
            "pod_weighted_bytes": coll_pod,
        },
        "roofline": {
            "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "t_collective_s": t_coll,
            "bottleneck": bottleneck,
            "bound_s": max(terms.values()),
            "roofline_fraction": (
                t_compute / max(terms.values()) if max(terms.values()) else 0
            ),
            "model_flops": mf,
            "useful_flops_fraction": (
                mf / (flops_dev * chips) if flops_dev else 0
            ),
        },
    }
    if verbose:
        print(json.dumps(result), flush=True)
    return result


def all_cells():
    for arch in ASSIGNED_NAMES:
        for shape in SHAPES:
            yield arch, shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--use-kernel", action="store_true",
                    help="refused: the kernels take CUDA tensors, a cell's "
                         "are meta")
    ap.add_argument("--dp-over-model", action="store_true",
                    help="pure data parallelism: batch over model axis too")
    ap.add_argument("--no-tp", action="store_true",
                    help="disable tensor/expert parallelism")
    ap.add_argument("--zero1", action="store_true",
                    help="ZeRO-1: bf16 compute params replicated over data")
    ap.add_argument("--tag", default=None, help="label for perf iterations")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)

    opts = ShardingOptions(
        fsdp=not args.no_fsdp,
        tensor_parallel=not args.no_tp,
        expert_parallel=not args.no_tp,
    )
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    done = set()
    if args.out and args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") in ("ok", "skipped"):
                        done.add((r.get("cell"), r.get("mesh", mesh_name)))
                except json.JSONDecodeError:
                    pass

    cells = (
        list(all_cells()) if args.all else [(args.arch, args.shape)]
    )
    results = []
    for arch, shape in cells:
        if (f"{arch}:{shape}", mesh_name) in done:
            print(f"# skip (done): {arch}:{shape}")
            continue
        try:
            r = run_cell(
                arch, shape, multi_pod=args.multi_pod, opts=opts,
                microbatches=args.microbatches, use_kernel=args.use_kernel,
                dp_over_model=args.dp_over_model, zero1=args.zero1,
            )
        except Exception as e:  # a cell failure is a bug — record it
            traceback.print_exc()
            r = {"cell": f"{arch}:{shape}", "mesh": mesh_name,
                 "status": "error", "error": f"{type(e).__name__}: {e}"}
            print(json.dumps(r), flush=True)
        if args.tag:
            r["tag"] = args.tag
        results.append(r)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_skip = sum(1 for r in results if r.get("status") == "skipped")
    n_err = sum(1 for r in results if r.get("status") == "error")
    print(f"# dry-run complete: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
