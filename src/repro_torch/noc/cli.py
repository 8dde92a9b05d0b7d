"""Command-line driver for the port's NoC optimization API.

    PYTHONPATH=src python -m repro_torch.noc run --spec 64 --app BFS \
        --case case5 --optimizer stage --max-evals 2000 --out run.json
    PYTHONPATH=src python -m repro_torch.noc run --smoke --device cpu

``run`` executes one optimizer and prints (optionally saves) a RunResult.
``--device`` picks the device (default ``cuda``; there is no fallback to
the CPU). Optimizer config overrides are ``--set key=value`` (repeatable;
values parsed as Python literals, e.g. ``--set iters_max=3``).
"""

from __future__ import annotations

import argparse
import ast
import sys

import numpy as np

from .api import Budget, NocProblem, RunResult, named_spec, run
from .optimizers import optimizer_names


def _parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v  # bare string (e.g. --set meta_backend=host)
    return out


def _summary_line(res: RunResult) -> str:
    return (f"{res.optimizer}: pareto={len(res.designs)} "
            f"best_edp={res.best_edp():.4g} phv={res.phv():.4f} "
            f"evals={res.n_evals} calls={res.n_calls} "
            f"wall={res.wall_s:.1f}s"
            + (" [budget exhausted]" if res.exhausted else ""))


def cmd_run(args) -> int:
    if args.smoke:
        # Fixed tiny end-to-end exercise of the API surface: registry run
        # under a shared Budget, JSON round trip, budget accounting.
        problem = NocProblem(spec=named_spec("tiny"), traffic="BFS")
        res = run(problem, "stage", budget=Budget(max_evals=120, seed=0),
                  config={"iters_max": 2, "n_swaps": 4, "n_link_moves": 4,
                          "max_local_steps": 5}, device=args.device)
        back = RunResult.from_json(res.to_json())
        if not np.array_equal(np.asarray(back.objs), np.asarray(res.objs)):
            print("smoke FAILED: RunResult JSON round trip changed objectives")
            return 1
        if res.n_evals > 120 + 4 * 2 * 2:  # one lockstep round of overshoot
            print(f"smoke FAILED: budget not enforced (evals={res.n_evals})")
            return 1
        if not args.quiet:
            print(_summary_line(res))
        print("smoke ok")
        return 0

    traffic = tuple(args.avg.split(",")) if args.avg else args.app
    problem = NocProblem(spec=named_spec(args.spec), traffic=traffic,
                         case=args.case, forest_backend=args.forest_backend)
    budget = Budget(max_evals=args.max_evals, max_calls=args.max_calls,
                    seed=args.seed)
    overrides = _parse_overrides(args.set)
    res = run(problem, args.optimizer, budget=budget,
              config=overrides or None, device=args.device)
    if not args.quiet:
        print(_summary_line(res))
        for d_obj in np.asarray(res.objs):
            print("  objs: " + " ".join(f"{v:.5g}" for v in d_obj))
    if args.out:
        res.save(args.out)
        if not args.quiet:
            print(f"saved {args.out}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.noc",
        description="NoC optimization driver (PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="command", required=True)

    ap_run = sub.add_parser("run", help="run one optimizer on one problem")
    ap_run.add_argument("--spec", default="tiny",
                        help="system spec: tiny|16|36|64 (default tiny)")
    ap_run.add_argument("--app", default="BFS", help="application traffic")
    ap_run.add_argument("--avg", default=None,
                        help="comma-separated apps; use their aggregated "
                             "traffic instead of --app")
    ap_run.add_argument("--case", default="case3",
                        help="objective case (case1..case5, default case3)")
    ap_run.add_argument("--forest-backend", default="auto",
                        help="surrogate inference backend auto|numpy "
                             "(default auto: the device path)")
    ap_run.add_argument("--max-evals", type=int, default=None)
    ap_run.add_argument("--max-calls", type=int, default=None)
    ap_run.add_argument("--seed", type=int, default=0)
    ap_run.add_argument("--optimizer", default="stage",
                        help=f"one of {', '.join(optimizer_names())}")
    ap_run.add_argument("--set", action="append", default=[],
                        metavar="KEY=VALUE", help="optimizer config override")
    ap_run.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    ap_run.add_argument("--out", default=None, help="save RunResult JSON")
    ap_run.add_argument("--smoke", action="store_true",
                        help="fixed tiny self-check")
    ap_run.add_argument("--quiet", action="store_true")
    ap_run.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
