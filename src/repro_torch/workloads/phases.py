"""Phase-sequenced traces and trace-level design scoring.

A real workload is not one static matrix: training beats fwd -> bwd ->
grad-sync, serving beats prefill -> decode, and each phase has its own
traffic structure and duration share. A :class:`PhaseTrace` names that
sequence; `phase_weighted_edp` scores a candidate NoC over the whole trace
(duration-weighted mean of per-phase network EDP) instead of a single
matrix, and `trace_link_report` gives the phase-weighted per-link
utilization profile — the original caller of the path-walk kernel K4
(`kernels.ops.walk`: the CUDA kernel for tensors on the card, its plain
version for tensors on the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import routing
from ..core.evaluate import Evaluator
from ..core.objectives import design_cost, make_consts
from ..core.problem import Design, SystemSpec
from ..core.traffic import TrafficValidationError
from ..device import resolve_device
from ..kernels import ops

from .traffic_model import check_scenario, scenario_matrix


# ------------------------------------------------------------------- traces
@dataclasses.dataclass(frozen=True)
class Phase:
    """One leg of a trace: a scenario phase plus its duration share."""

    name: str      # e.g. "train.fwd"
    weight: float  # relative duration (cycles spent in this phase)


@dataclasses.dataclass(frozen=True)
class PhaseTrace:
    arch: str
    workload: str                 # "training" | "serving"
    phases: tuple[Phase, ...]

    @property
    def total_weight(self) -> float:
        return sum(p.weight for p in self.phases)

    def scenario_names(self) -> tuple[str, ...]:
        return tuple(f"{self.arch}:{p.name}" for p in self.phases)


#: duration shares: bwd costs ~2x fwd (dgrad + wgrad); grad-sync is a short
#: pure-communication burst; decode steps dominate a serving request's life.
TRACE_PHASES = {
    "training": (("train.fwd", 1.0), ("train.bwd", 2.0),
                 ("train.grad_sync", 0.5)),
    "serving": (("serve.prefill", 1.0), ("serve.decode", 4.0)),
}

WORKLOADS = tuple(TRACE_PHASES)


def trace_for(arch: str, workload: str = "training") -> PhaseTrace:
    if workload not in TRACE_PHASES:
        raise TrafficValidationError(
            f"unknown workload {workload!r}; known: {', '.join(WORKLOADS)}")
    phases = tuple(Phase(n, w) for n, w in TRACE_PHASES[workload])
    for p in phases:
        check_scenario(arch, p.name)
    return PhaseTrace(arch=arch, workload=workload, phases=phases)


def trace_matrices(spec: SystemSpec, trace: PhaseTrace,
                   mesh=None) -> list[tuple[Phase, np.ndarray]]:
    return [(p, scenario_matrix(spec, trace.arch, p.name, mesh=mesh))
            for p in trace.phases]


# ---------------------------------------------------------------- scoring
#: evaluators hold device tensors — reuse them per (spec, scenario, device).
_EV_CACHE: dict = {}


def evaluator_for(spec: SystemSpec, arch: str, phase: str, mesh=None,
                  backend: str = "auto", device=None) -> Evaluator:
    dev = resolve_device(device)
    key = (spec, arch, phase, tuple(mesh) if mesh is not None else None,
           backend, str(dev))
    ev = _EV_CACHE.get(key)
    if ev is None:
        f = scenario_matrix(spec, arch, phase, mesh=mesh)
        ev = _EV_CACHE[key] = Evaluator(spec, f, backend=backend, device=dev)
    return ev


def phase_weighted_edp(spec: SystemSpec, design: Design, trace: PhaseTrace,
                       *, mesh=None, backend: str = "auto",
                       device=None) -> dict:
    """Duration-weighted network EDP of ``design`` over ``trace``.

    Returns ``{"edp", "per_phase": {phase: edp}, "weights": {phase: w}}`` —
    ``edp`` is sum(w_p * edp_p) / sum(w_p), the trace-level analogue of the
    single-matrix `Evaluator.edp`."""
    per_phase, weights = {}, {}
    acc = 0.0
    for p in trace.phases:
        ev = evaluator_for(spec, trace.arch, p.name, mesh=mesh,
                           backend=backend, device=device)
        e = ev.edp(design)
        per_phase[p.name] = e
        weights[p.name] = p.weight
        acc += p.weight * e
    return {"edp": acc / trace.total_weight, "per_phase": per_phase,
            "weights": weights}


# ------------------------------------------------------------- link report
def link_walk_inputs(spec: SystemSpec, design: Design, trace: PhaseTrace,
                     *, mesh=None, device=None):
    """What `trace_link_report` walks, on ``device`` (default ``"cuda"``):
    ``(consts, nh, [(phase, f_slots)])`` — the design's (1, N, N) next hops
    from its APSP (K1 on the card) and each phase's (1, N, N) f32 traffic
    between slots."""
    dev = resolve_device(device)
    consts = make_consts(spec, str(dev))
    n = spec.n_tiles
    adj = torch.as_tensor(design.adj, dtype=torch.bool, device=dev)[None]
    cost = design_cost(consts, adj)
    _, nh = routing.routing_tables_batched(cost, consts.apsp_iters)
    perm = np.asarray(design.perm)
    eye = 1.0 - np.eye(n)
    phases = []
    for p, f in trace_matrices(spec, trace, mesh=mesh):
        f_slots = np.asarray(f)[perm][:, perm] * eye
        phases.append((p, torch.as_tensor(f_slots[None], dtype=torch.float32,
                                          device=dev)))
    return consts, nh, phases


def trace_link_report(spec: SystemSpec, design: Design, trace: PhaseTrace,
                      *, mesh=None, device=None) -> dict:
    """Phase-weighted per-link utilization of ``design`` under ``trace``.

    Each phase's traffic is walked along the design's routing paths with
    `kernels.ops.walk` (one K4 call per phase on the card; the device of
    ``device``, default ``"cuda"``, decides); directed utilizations are
    folded to undirected links and blended by phase duration. Returns::

        {"util": (N, N) phase-weighted undirected link utilization,
         "visits": (N,) phase-weighted router traversals,
         "max_link": ((a, b), value), "mean": float, "std": float}
    """
    consts, nh, phases = link_walk_inputs(spec, design, trace, mesh=mesh,
                                          device=device)
    n = spec.n_tiles
    util_acc = np.zeros((n, n))
    visits_acc = np.zeros((n,))
    for p, f_slots in phases:
        _, _, util, visits, _ = ops.walk(nh, f_slots, consts.link_delay,
                                         consts.max_hops)
        w = p.weight / trace.total_weight
        util_d = util[0].cpu().numpy().astype(np.float64)
        util_acc += w * (util_d + util_d.T)
        visits_acc += w * visits[0].cpu().numpy().astype(np.float64)

    link_mask = np.triu(np.asarray(design.adj) | spec.vertical_adj, 1)
    present = util_acc[link_mask]
    flat = np.where(link_mask, util_acc, 0.0)
    a, b = np.unravel_index(int(np.argmax(flat)), flat.shape)
    return {
        "util": util_acc,
        "visits": visits_acc,
        "max_link": ((int(a), int(b)), float(flat[a, b])),
        "mean": float(present.mean()) if present.size else 0.0,
        "std": float(present.std()) if present.size else 0.0,
    }
