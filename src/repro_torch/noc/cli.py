"""Command-line driver for the port's NoC optimization API.

    PYTHONPATH=src python -m repro_torch.noc run --spec 64 --app BFS \
        --case case5 --optimizer stage --max-evals 2000 --out run.json
    PYTHONPATH=src python -m repro_torch.noc run --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.noc run --spec 64 \
        --traffic model:yi-6b:serve.decode --max-evals 500
    PYTHONPATH=src python -m repro_torch.noc compare --spec tiny --app BFS \
        --optimizers stage,amosa,nsga2 --max-evals 600
    PYTHONPATH=src python -m repro_torch.noc agnostic --spec 16 --apps BFS,BP,CDN

``run`` executes one optimizer and prints (optionally saves) a RunResult;
``compare`` runs several optimizers on one problem at an equal budget;
``agnostic`` reproduces the Fig. 9 cross-execution study. ``--device``
picks the device (default ``cuda``; there is no fallback to the CPU).
Optimizer config overrides are ``--set key=value`` (repeatable; values
parsed as Python literals, e.g. ``--set iters_max=3``).
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


def parse_traffic_arg(value: str):
    """``model:<arch>:<phase>`` -> a model-scenario dict; anything else is
    an application name (validated by NocProblem)."""
    if value.startswith("model:"):
        _, _, rest = value.partition(":")
        arch, sep, phase = rest.partition(":")
        spec = {"model": arch}
        if sep:
            spec["phase"] = phase
        return spec
    return value


def _build_problem(args) -> NocProblem:
    if args.traffic:
        traffic = parse_traffic_arg(args.traffic)
    elif args.avg:
        traffic = tuple(args.avg.split(","))
    else:
        traffic = args.app
    return NocProblem(spec=named_spec(args.spec), traffic=traffic,
                      case=args.case, forest_backend=args.forest_backend)


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

    problem = _build_problem(args)
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


def cmd_compare(args) -> int:
    problem = _build_problem(args)
    budget = Budget(max_evals=args.max_evals, max_calls=args.max_calls,
                    seed=args.seed)
    names = args.optimizers.split(",")
    overrides = _parse_overrides(args.set)
    if unknown := set(overrides) - set(names):
        raise SystemExit(
            f"--set keys {sorted(unknown)} match none of the requested "
            f"optimizers {names}")
    results: dict[str, RunResult] = {}
    for name in names:
        # Fresh evaluator per optimizer: equal budgets, independent counters.
        results[name] = run(problem, name, budget=budget,
                            config=overrides.get(name), device=args.device)
        print(_summary_line(results[name]))
    best = min(results, key=lambda n: results[n].best_edp())
    print(f"best final EDP: {best} ({results[best].best_edp():.4g})")
    if args.out:
        import json

        with open(args.out, "w") as fh:
            json.dump({n: r.to_json() for n, r in results.items()}, fh)
        print(f"saved {args.out}")
    return 0


def cmd_agnostic(args) -> int:
    from ..core.agnostic import (OptimizeBudget, run_agnostic_study,
                                 summarize)
    from ..core.traffic import APP_NAMES

    spec = named_spec(args.spec)
    apps = tuple(args.apps.split(",")) if args.apps else APP_NAMES[:4]
    budget = OptimizeBudget(iters_max=args.iters, n_swaps=args.moves,
                            n_link_moves=args.moves,
                            max_local_steps=args.local_steps, seed=args.seed)
    res = run_agnostic_study(spec, apps, args.case, budget,
                             device=args.device)
    hdr = "          " + " ".join(f"{a:>6s}" for a in apps)
    print("normalized EDP (row: NoC optimized for; col: app executed):")
    print(hdr)
    for i, a in enumerate(apps):
        print(f"{a:>8s}  " + " ".join(f"{v:6.3f}" for v in res["table"][i]))
    print(f"{'AVG':>8s}  " + " ".join(f"{v:6.3f}" for v in res["avg_row"]))
    s = summarize(res)
    print(f"single-app degradation: avg "
          f"{s['app_specific_avg_degradation']*100:.1f}%, worst "
          f"{s['app_specific_worst_degradation']*100:.1f}%; AVG NoC: avg "
          f"{s['avg_noc_degradation']*100:.1f}%, worst "
          f"{s['avg_noc_worst']*100:.1f}%")
    return 0


def _problem_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--spec", default="tiny",
                    help="system spec: tiny|16|36|64 (default tiny)")
    ap.add_argument("--app", default="BFS", help="application traffic")
    ap.add_argument("--avg", default=None,
                    help="comma-separated apps; use their aggregated "
                         "traffic instead of --app")
    ap.add_argument("--traffic", default=None,
                    help="explicit traffic spec, overriding --app/--avg: "
                         "model:<arch>:<phase> derives traffic from a model "
                         "config (repro_torch.workloads; e.g. "
                         "model:yi-6b:serve.decode), any other value is an "
                         "application name")
    ap.add_argument("--case", default="case3",
                    help="objective case (case1..case5, default case3)")
    ap.add_argument("--forest-backend", default="auto",
                    help="surrogate inference backend auto|numpy "
                         "(default auto: the device path)")


def _budget_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--max-evals", type=int, default=None)
    ap.add_argument("--max-calls", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)


def _device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.noc",
        description="NoC optimization driver (PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="command", required=True)

    ap_run = sub.add_parser("run", help="run one optimizer on one problem")
    _problem_args(ap_run)
    _budget_args(ap_run)
    ap_run.add_argument("--optimizer", default="stage",
                        help=f"one of {', '.join(optimizer_names())}")
    ap_run.add_argument("--set", action="append", default=[],
                        metavar="KEY=VALUE", help="optimizer config override")
    _device_arg(ap_run)
    ap_run.add_argument("--out", default=None, help="save RunResult JSON")
    ap_run.add_argument("--smoke", action="store_true",
                        help="fixed tiny self-check")
    ap_run.add_argument("--quiet", action="store_true")
    ap_run.set_defaults(fn=cmd_run)

    ap_cmp = sub.add_parser("compare",
                            help="run several optimizers at equal budget")
    _problem_args(ap_cmp)
    _budget_args(ap_cmp)
    ap_cmp.add_argument("--optimizers", default="stage,amosa,nsga2")
    ap_cmp.add_argument("--set", action="append", default=[],
                        metavar="NAME=CONFIG_DICT",
                        help="per-optimizer config dict, e.g. "
                             "--set \"amosa={'alpha':0.9}\"")
    _device_arg(ap_cmp)
    ap_cmp.add_argument("--out", default=None, help="save all RunResults")
    ap_cmp.set_defaults(fn=cmd_compare)

    ap_ag = sub.add_parser("agnostic",
                           help="Fig. 9 application-agnostic cross table")
    ap_ag.add_argument("--spec", default="16")
    ap_ag.add_argument("--apps", default=None,
                       help="comma-separated (default: first 4)")
    ap_ag.add_argument("--case", default="case3")
    ap_ag.add_argument("--iters", type=int, default=2)
    ap_ag.add_argument("--moves", type=int, default=10)
    ap_ag.add_argument("--local-steps", type=int, default=12)
    ap_ag.add_argument("--seed", type=int, default=0)
    _device_arg(ap_ag)
    ap_ag.set_defaults(fn=cmd_agnostic)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
