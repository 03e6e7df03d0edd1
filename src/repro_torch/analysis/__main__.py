"""CLI: ``python -m repro_torch.analysis --all [--device cpu]``
(``docs/static_analysis_torch.md``).

Exit code 0 iff every pass over every selected program is clean modulo
the allowlist; allowlisted findings are printed with their reasons so
the recorded debt stays visible. The programs run on the card unless
``--device cpu`` is given; asking for ``cuda`` without a GPU raises.
"""
from __future__ import annotations

import argparse
import sys
import time

from ..layers.common import resolve_device
from .framework import PASSES, AnalysisReport, run_passes
from .programs import DEFAULT_ALLOWLIST, GRID, build_program_specs, \
    kernel_program_specs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Contract linter for the port's serving/training "
                    "stack (recorded eager runs + AST passes).",
    )
    ap.add_argument("--all", action="store_true",
                    help="whole arch grid, all passes")
    ap.add_argument("--arch", action="append", default=None,
                    help="restrict to arch(s) (repeatable); "
                         f"grid: {', '.join(GRID)}")
    ap.add_argument("--passes", default=None,
                    help="comma-separated pass subset "
                         f"(registered: {', '.join(sorted(PASSES))})")
    ap.add_argument("--no-train", action="store_true",
                    help="skip the train-step program")
    ap.add_argument("--list", action="store_true",
                    help="list archs and passes, then exit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the programs run (default: the card)")
    args = ap.parse_args(argv)

    if args.list:
        print("archs:", " ".join(GRID))
        print("passes:", " ".join(sorted(PASSES)))
        return 0
    if not args.all and not args.arch:
        ap.error("pick --all or --arch NAME")

    dev = resolve_device(args.device)
    archs = list(args.arch) if args.arch else list(GRID)
    pass_names = args.passes.split(",") if args.passes else sorted(PASSES)

    report = AnalysisReport()
    t0 = time.time()
    # program passes run per arch; host-purity is source-level and runs
    # exactly once at the end
    prog_passes = [p for p in pass_names if p != "host-purity"]
    if prog_passes:
        for i, arch in enumerate(archs):
            print(f"[{i + 1}/{len(archs)}] {arch} ...", flush=True)
            specs = build_program_specs(arch, train=not args.no_train,
                                        device=dev)
            report.merge(
                run_passes(specs, prog_passes, DEFAULT_ALLOWLIST)
            )
        # arch-independent: the Soft-MoE kernel grad program
        report.merge(run_passes(kernel_program_specs(device=dev),
                                prog_passes, DEFAULT_ALLOWLIST))
    if "host-purity" in pass_names:
        report.merge(run_passes([], ["host-purity"], DEFAULT_ALLOWLIST))

    print(report.render())
    print(f"({time.time() - t0:.1f}s, {len(archs)} arch(s), "
          f"{len(pass_names)} pass(es), {dev.type})")
    return 0 if report.ok() else 1


if __name__ == "__main__":
    sys.exit(main())
