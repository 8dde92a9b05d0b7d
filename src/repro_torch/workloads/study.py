"""Cross-workload agnostic study: paper apps vs. model-derived traffic.

The paper's application-agnostic claim (§6.4: a NoC optimized on an
aggregate of a few apps loses only 1-2% EDP on unseen ones) was measured
on ten Rodinia-class traces whose traffic is structurally alike
(near-uniform many-to-few GPU<->LLC). LLM phase traffic is not alike —
MoE all-to-all puts mass on GPU<->GPU, decode concentrates reads on home
LLC banks. `run_cross_workload_study` asks the question directly: optimize
NoCs per scenario plus two aggregates (AVG over paper apps, AVG over LLM
scenarios), cross-execute everything, and report how far a
paper-apps-optimized NoC degrades on LLM traffic (and vice versa).
"""

from __future__ import annotations

import numpy as np

from ..core.agnostic import OptimizeBudget, optimize_for_traffic
from ..core.evaluate import Evaluator
from ..core.problem import SystemSpec
from ..core.traffic import APPLICATIONS, traffic_matrix

from .traffic_model import (PHASE_INTENSITY, parse_scenario, scenario_matrix)

#: curated scenario set spanning the structures the paper corpus lacks:
#: dense-transformer training, pure-communication grad-sync, MoE training
#: (all-to-all), and memory-bound serving decode (many-to-few LLC reads).
LLM_STUDY_SCENARIOS = (
    "yi-6b:train.fwd",
    "mistral-large-123b:train.grad_sync",
    "qwen3-moe-30b-a3b:train.fwd",
    "moonshot-v1-16b-a3b:train.fwd",
    "yi-6b:serve.decode",
    "qwen3-moe-30b-a3b:serve.decode",
)

AVG_PAPER = "AVG:paper"
AVG_LLM = "AVG:llm"


def _avg_of(mats: list[np.ndarray], intensities: list[float]) -> np.ndarray:
    """Aggregate per `core.traffic.avg_traffic`: unit-normalize each matrix,
    mean, then rescale by the mean intensity."""
    unit = [m / m.sum() for m in mats]
    return np.mean(unit, axis=0) * float(np.mean(intensities))


def run_cross_workload_study(
    spec: SystemSpec,
    paper_apps: tuple[str, ...] = ("BP", "BFS", "LUD", "NW"),
    llm_scenarios: tuple[str, ...] = LLM_STUDY_SCENARIOS,
    case: str = "case3",
    budget: OptimizeBudget | None = None,
    mesh=None,
    device=None,
) -> dict:
    """Cross-execution table over paper apps + LLM scenarios + aggregates,
    every search and evaluation on ``device`` (default ``"cuda"``).

    result['table'][i, j]: EDP of NoC_i on workload_j, normalized to the
    EDP of workload_j's own NoC (diagonal == 1 for single workloads).
    Rows include AVG:paper and AVG:llm — NoCs optimized on each corpus's
    aggregate, evaluated everywhere; their cross-corpus rows are the
    generalization-gap measurement."""
    budget = budget or OptimizeBudget()

    mats: dict[str, np.ndarray] = {}
    for a in paper_apps:
        mats[a] = traffic_matrix(spec, a)
    for s in llm_scenarios:
        arch, phase = parse_scenario(s)
        mats[s] = scenario_matrix(spec, arch, phase, mesh=mesh)

    workloads = tuple(paper_apps) + tuple(llm_scenarios)
    mats[AVG_PAPER] = _avg_of(
        [mats[a] for a in paper_apps],
        [APPLICATIONS[a]["intensity"] for a in paper_apps])
    mats[AVG_LLM] = _avg_of(
        [mats[s] for s in llm_scenarios],
        [PHASE_INTENSITY[parse_scenario(s)[1]] for s in llm_scenarios])

    rows = workloads + (AVG_PAPER, AVG_LLM)
    evs = {w: Evaluator(spec, mats[w], device=device) for w in workloads}
    designs = {}
    for r in rows:
        d, _, _ = optimize_for_traffic(spec, mats[r], case, budget, device)
        designs[r] = d

    diag = {w: evs[w].edp(designs[w]) for w in workloads}
    table = np.zeros((len(rows), len(workloads)))
    for i, r in enumerate(rows):
        for j, w in enumerate(workloads):
            table[i, j] = evs[w].edp(designs[r]) / diag[w]

    n_paper = len(paper_apps)
    paper_cols = slice(0, n_paper)
    llm_cols = slice(n_paper, len(workloads))
    i_avg_paper = rows.index(AVG_PAPER)
    i_avg_llm = rows.index(AVG_LLM)
    summary = {
        # a paper-apps NoC, judged on LLM traffic (the headline gap)
        "paper_on_llm_avg": float(table[i_avg_paper, llm_cols].mean() - 1.0),
        "paper_on_llm_worst": float(table[i_avg_paper, llm_cols].max() - 1.0),
        # and the mirror image
        "llm_on_paper_avg": float(table[i_avg_llm, paper_cols].mean() - 1.0),
        "llm_on_paper_worst": float(table[i_avg_llm, paper_cols].max() - 1.0),
        # each corpus's aggregate on its own corpus (the paper's §6.4 claim)
        "paper_on_paper_avg": float(table[i_avg_paper, paper_cols].mean() - 1.0),
        "llm_on_llm_avg": float(table[i_avg_llm, llm_cols].mean() - 1.0),
    }
    return dict(rows=rows, workloads=workloads, table=table,
                designs=designs, summary=summary)


def format_cross_table(result: dict) -> str:
    """Human-readable cross table."""
    rows, cols, t = result["rows"], result["workloads"], result["table"]
    w = max(len(r) for r in rows) + 2
    cw = max(max((len(c) for c in cols), default=8), 6) + 1
    lines = [" " * w + "".join(f"{c:>{cw}}" for c in cols)]
    for i, r in enumerate(rows):
        lines.append(f"{r:<{w}}" +
                     "".join(f"{t[i, j]:>{cw}.3f}" for j in range(len(cols))))
    s = result["summary"]
    lines.append("")
    lines.append(
        f"paper-apps NoC on LLM traffic: avg +{s['paper_on_llm_avg']:.1%} "
        f"/ worst +{s['paper_on_llm_worst']:.1%}")
    lines.append(
        f"LLM NoC on paper traffic:      avg +{s['llm_on_paper_avg']:.1%} "
        f"/ worst +{s['llm_on_paper_worst']:.1%}")
    return "\n".join(lines)
