"""Application-agnostic NoC design studies (paper §6.4-§6.5, Figs. 9-11).

For every application, optimize (i) an application-specific NoC on its own
traffic and (ii) an 'AVG' NoC on the aggregated leave-one-out traffic of the
*other* applications. Then cross-execute: every NoC runs every application
and its EDP is normalized to that application's own application-specific
NoC. The paper's claim: the AVG NoC's degradation is ~1-2%."""

from __future__ import annotations

import dataclasses

import numpy as np

from .evaluate import Evaluator
from .objectives import peak_temperature_celsius
from .problem import Design, SystemSpec
from .traffic import APP_NAMES, avg_traffic, traffic_matrix


@dataclasses.dataclass
class OptimizeBudget:
    """Reduced-budget knobs (the paper ran hours on a Xeon).

    :meth:`to_noc` splits the bundle into the unified API's
    ``(Budget, StageConfig)`` pair."""

    iters_max: int = 4
    n_swaps: int = 16
    n_link_moves: int = 16
    max_local_steps: int = 40
    seed: int = 0

    def to_noc(self):
        """(noc.Budget, noc.StageConfig) for this bundle."""
        from ..noc import Budget, StageConfig

        return (Budget(seed=self.seed),
                StageConfig(iters_max=self.iters_max, n_swaps=self.n_swaps,
                            n_link_moves=self.n_link_moves,
                            max_local_steps=self.max_local_steps))


def pick_min_edp(ev: Evaluator, designs: list[Design],
                 objs: np.ndarray) -> tuple[Design, np.ndarray]:
    """The paper characterizes each Pareto set by its best network EDP
    (§6.1); select that representative solution."""
    edps = objs[:, 2] * objs[:, 3]
    j = int(np.argmin(edps))
    return designs[j], objs[j]


def optimize_for_traffic(
    spec: SystemSpec,
    f: np.ndarray,
    case: str = "case3",
    budget: OptimizeBudget | None = None,
    device=None,
) -> tuple[Design, np.ndarray, Evaluator]:
    """Thin wrapper over the unified ``noc`` API: run MOO-STAGE on one
    traffic matrix on ``device`` (default ``"cuda"``) and return the min-EDP
    representative design (the per-application optimization step of the
    agnostic study)."""
    from ..noc import NocProblem, run as noc_run

    budget = budget or OptimizeBudget()
    noc_budget, stage_cfg = budget.to_noc()
    problem = NocProblem(spec=spec, traffic=f, case=case)
    ev = problem.evaluator(device=device)
    res = noc_run(problem, "stage", budget=noc_budget, config=stage_cfg,
                  ev=ev)
    d, o = pick_min_edp(ev, res.designs, np.asarray(res.objs))
    return d, o, ev


def run_agnostic_study(
    spec: SystemSpec,
    apps: tuple[str, ...] = APP_NAMES,
    case: str = "case3",
    budget: OptimizeBudget | None = None,
    include_avg: bool = True,
    device=None,
) -> dict:
    """Returns the Fig. 9/11 cross table, every search and evaluation on
    ``device`` (default ``"cuda"``).

    result['table'][i, j]: EDP of NoC_i running app_j, normalized by the EDP
    of app_j's own NoC running app_j. result['avg_row'][j]: same for the
    leave-one-out AVG NoC of app_j."""
    budget = budget or OptimizeBudget()
    evs = {a: Evaluator(spec, traffic_matrix(spec, a), device=device)
           for a in apps}
    designs: dict[str, Design] = {}
    for a in apps:
        d, _, _ = optimize_for_traffic(spec, traffic_matrix(spec, a), case,
                                       budget, device)
        designs[a] = d

    def edp_of(d: Design, app: str) -> float:
        return evs[app].edp(d)

    diag = {a: edp_of(designs[a], a) for a in apps}
    table = np.zeros((len(apps), len(apps)))
    for i, ai in enumerate(apps):
        for j, aj in enumerate(apps):
            table[i, j] = edp_of(designs[ai], aj) / diag[aj]

    out = dict(apps=apps, table=table, designs=designs)
    if include_avg:
        avg_row = np.zeros(len(apps))
        avg_designs = {}
        for j, aj in enumerate(apps):
            rest = [x for x in apps if x != aj]
            d, _, _ = optimize_for_traffic(spec, avg_traffic(spec, rest),
                                           case, budget, device)
            avg_designs[aj] = d
            avg_row[j] = edp_of(d, aj) / diag[aj]
        out["avg_row"] = avg_row
        out["avg_designs"] = avg_designs
    return out


def summarize(result: dict) -> dict:
    """Average / worst degradation of off-diagonal and AVG rows (the numbers
    the paper quotes: e.g. 64-tile Case-3: 3.2% avg / 9.8% worst; AVG 1.1%)."""
    t = result["table"]
    off = t[~np.eye(t.shape[0], dtype=bool)]
    out = dict(
        app_specific_avg_degradation=float(off.mean() - 1.0),
        app_specific_worst_degradation=float(off.max() - 1.0),
    )
    if "avg_row" in result:
        out["avg_noc_degradation"] = float(result["avg_row"].mean() - 1.0)
        out["avg_noc_worst"] = float(result["avg_row"].max() - 1.0)
    return out


def thermal_study(
    spec: SystemSpec,
    app: str,
    budget: OptimizeBudget | None = None,
    device=None,
) -> dict:
    """Fig. 10: Cases 3 (perf-only), 4 (thermal-only), 5 (joint) compared on
    latency proxy, EDP, and peak temperature (deg C)."""
    budget = budget or OptimizeBudget()
    f = traffic_matrix(spec, app)
    out = {}
    for case in ("case3", "case4", "case5"):
        d, o, ev = optimize_for_traffic(spec, f, case, budget, device)
        out[case] = dict(
            design=d,
            objs=o,
            edp=ev.edp(d),
            latency=float(o[2]),
            energy=float(o[3]),
            temp_metric=float(o[4]),
            peak_celsius=peak_temperature_celsius(ev.consts, d.perm),
        )
    return out
