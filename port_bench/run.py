"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The last line of standard output is the
result (JSON); everything else goes to standard error, the numbers
compared for ``correct`` last. The run fails, and prints no result, where
torch sees no CUDA device or fewer than the cell asks for, where the port
(``src/repro_torch``) is missing, or where JAX or the JAX package
(``repro``) got loaded. The port's CUDA libraries are built into
``build/repro_torch/`` of the checkout on the first run there.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _finite(x):
    """The result with every non-finite number as its string ("inf")."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no port at {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 2
    # every cache the run could write stays inside the checkout
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "nv_cache"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from port_bench import harness

    cell = harness.Cell(args.workload)
    chips = cell.entry["chips"]
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch sees "
              f"{seen}", file=sys.stderr)
        return 3
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda:0", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
