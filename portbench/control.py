"""Readings that the limits of :mod:`portbench.checks` are set from.

For one cell, in one process on the card: set up once, then for each seed
run whole searches back to back for ``seconds``, as a benchmark run does
but each with its own seed drawn from the run's (not the mix's pool, so
that a dozen seeds read hundreds of different searches), and judge what
they produced twice: as the program returned it (the lower readings) and
with the control, the reference computed in bfloat16, put in the
program's place (the upper readings). One JSON line per seed on standard
output, with each search's seed, wall seconds, reference PHV and EDP
ratio::

    python3 portbench/control.py --workload NAME --seconds S --seeds 1 2 3

The benchmark's own runs do not run this.
"""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[0] = str(REPO)
sys.path.insert(1, str(REPO / "src"))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def readings(cell, seeds, seconds: float, device: str = "cuda"):
    """Yield one dict of program and control readings per seed."""
    import numpy as np

    from portbench import checks, harness, traffic

    prog = harness.Program(cell, device)
    prog.warm(seeds[0], False)
    budget = harness.budget_limit(cell.mix)
    for seed in seeds:
        draw = np.random.default_rng([seed, 1])
        searches, outputs = [], []
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            s, out = prog.search(traffic.search_seed(seed, len(searches) + 1),
                                 False, draw)
            searches.append(s)
            outputs.append(out)
        row = {"seed": seed, "searches": len(searches),
               "search_s": (searches[-1].t1 - searches[0].t0) / len(searches),
               "evals_spent": [s.n_evals for s in searches]}
        t0 = time.perf_counter()
        for side, control in (("program", False), ("control", True)):
            v = checks.judge(prog.system, prog.f, cell.config["obj_idx"],
                             budget, outputs, control=control)
            row[side] = {k: c["value"] for k, c in v.checks.items()}
            row[side + "_correct"] = v.correct
            if not control:
                row["per_search"] = [[s.seed, s.wall_s, p, e] for s, p, e
                                     in zip(searches, v.phv, v.edp_ratio)]
        row["judge_s"] = time.perf_counter() - t0
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.load_cell(args.workload)
    for row in readings(cell, args.seeds, args.seconds):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
