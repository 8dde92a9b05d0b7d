"""Run one cell of the port's benchmark once, on the CUDA device, and print
its result as the last line of standard output::

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cells are the ``workloads`` of ``BENCHMARK.json``. The run exits with
a code other than 0, and prints no result, when the cell's CUDA devices
are missing or when the JAX package or JAX itself was loaded. The numbers
that decided ``correct`` are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# The repository's root, not this script's folder, heads the path: the
# folder's module names (trace, ...) would shadow the standard library's.
sys.path[0] = str(REPO)
sys.path.insert(1, str(REPO / "src"))

#: Top-level modules that must not be loaded in the process that reports.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"portbench: the process loaded {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
