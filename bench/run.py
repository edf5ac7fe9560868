"""The benchmark's command: one run of one cell on the card.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints diagnostics, then as its last line on standard output one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
check compared beside its limit), and the same checks as its last lines
on standard error.  Exits non-zero, printing no result, where there is no
CUDA card or fewer than the cell asks for, or where the run has loaded
JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from bench import harness

    bench = harness.load_benchmark(ROOT)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda:0",
                           t_start=T_START)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"the run loaded {loaded}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 3
    result = out["result"]
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name}: {json.dumps(c)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
