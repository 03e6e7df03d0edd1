"""Readings that set a cell's limits for ``correct``, on the card.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--seconds 3]

In one process: the program's numbers on each of ``--seeds`` (the lower
readings: a run with a short window, compared as a benchmark run compares
it), the control's on each of ``--control-seeds`` (the plain reference in
float8 put in the program's place, against the f32 reference: the upper
readings), and each fault of ``faults.py`` the cell can have planted in
the program on each of ``--fault-seeds``. One JSON line a reading on
standard output.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(cfg: dict, tr: dict, seed: int, device) -> dict:
    """The control: the reference in float8 against the reference in f32,
    on the cell's sizes, weights and batches."""
    from port_bench import compare, traffic
    from port_bench.reference import module_of
    from port_bench.reference import train as ref_train

    model = module_of(cfg)
    spec = model.param_spec(cfg)
    ring = traffic.make_ring(cfg, tr, seed, device)
    if tr["mode"] == "train":
        batches = ring[:tr.get("checked_steps", 3)]
        tel = tr.get("telemetry", False)
        low, ref = (ref_train.train_readout(
            model, cfg, spec, tr["optimizer"], seed, batches, device, prec,
            telemetry=tel) for prec in ("fp8", "f32"))
        return compare.train_numbers(low, ref)
    inputs = [b["patches"] for b in ring]
    low, ref = (ref_train.infer_logits(model, cfg, spec, seed, inputs, device,
                                       prec) for prec in ("fp8", "f32"))
    answers = [(i, lg, lg.topk(5, dim=-1).indices.cpu())
               for i, lg in enumerate(low)]
    return compare.infer_numbers(answers, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from port_bench import faults, harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    cell = harness.Cell(args.workload)

    def emit(kind, seed, numbers, extra=None):
        print(json.dumps({"cell": args.workload, "kind": kind, "seed": seed,
                          "numbers": numbers, **(extra or {})}), flush=True)

    def program_run(seed):
        t = time.perf_counter()
        res = harness.run(cell, seed, args.seconds, False, device, t)
        gc.collect()
        torch.cuda.empty_cache()
        return ({k: v["value"] for k, v in res["checks"].items()},
                {"correct": res["correct"], "attempted": res["attempted"],
                 "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                 "seconds": time.perf_counter() - t})

    for seed in args.seeds:
        numbers, extra = program_run(seed)
        emit("program", seed, numbers, extra)
    for seed in args.control_seeds:
        t = time.perf_counter()
        numbers = control_numbers(cell.config, cell.traffic, seed, device)
        emit("control_fp8", seed, numbers,
             {"seconds": time.perf_counter() - t})
        gc.collect()
        torch.cuda.empty_cache()
    family = cell.config["family"]
    for name, fault in faults.for_mode(cell.traffic["mode"],
                                       family).items():
        for seed in args.fault_seeds:
            with fault():
                numbers, extra = program_run(seed)
            emit(f"fault_{name}", seed, numbers, extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
