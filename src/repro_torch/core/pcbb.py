"""PCBB — priority & compensation-factor-oriented branch and bound (Wu et
al. [12]), adapted for 3D heterogeneous NoC design exactly as the paper
describes (§6.1):

  1. branching in two stages — node (tile) placement first, then link
     placement;
  2. bounds estimated by ROLL-OUT: the partial design is virtually completed
     with well-known mapping strategies (greedy, random, small-world) and the
     best completion's scalarized objective is the branch bound;
  3. objectives combined into a single scalarized metric;
  4. a branch is pruned only if its bound is worse than the incumbent even
     after the compensation factor (bound-estimation-error allowance).

Branching is over core TYPES per slot (cores of a type are interchangeable),
visited in slot order; the link stage is a bounded greedy descent from the
mesh link set. PCBB does systematic enumeration, so it is only tractable for
small systems (the paper itself reports ~141x MOO-STAGE's time at 64 tiles;
it runs here at 8-16 tiles, or under an evaluation budget)."""

from __future__ import annotations

import dataclasses

import numpy as np

from .evaluate import Evaluator
from .local_search import ParetoSet, SearchHistory
from .pareto import PhvContext
from .problem import CPU, GPU, LLC, Design, SystemSpec


def _scalarize(ctx: PhvContext, objs: np.ndarray) -> float:
    return float(ctx.normalize(objs).mean())


@dataclasses.dataclass
class PcbbResult:
    best: Design
    best_objs: np.ndarray
    pareto: ParetoSet
    nodes_expanded: int
    nodes_pruned: int


def _complete_greedy(spec: SystemSpec, types: list[int], counts: dict[int, int],
                     rng: np.random.Generator) -> np.ndarray:
    """Greedy completion: LLCs to middle layers, CPUs near LLCs, GPUs to the
    sink (the placement heuristics the paper's Figs. 7/12 identify)."""
    n = spec.n_tiles
    remaining = {t: c for t, c in counts.items()}
    out_types = list(types)
    mid = (spec.n_layers - 1) / 2.0
    slots = list(range(len(types), n))
    # Score slots: LLC prefers middle layers, GPU prefers sink (layer 0).
    for s in slots:
        k = spec.coords[s][0]
        prefs = sorted(
            [(abs(k - mid), LLC), (k, GPU), (abs(k - mid) + 0.5, CPU)]
        )
        placed = False
        for _, t in prefs:
            if remaining.get(t, 0) > 0:
                out_types.append(t)
                remaining[t] -= 1
                placed = True
                break
        if not placed:
            raise RuntimeError(f"greedy completion ran out of cores at slot {s}")
    return _types_to_perm(spec, out_types)


def _complete_random(spec: SystemSpec, types: list[int], counts: dict[int, int],
                     rng: np.random.Generator) -> np.ndarray:
    pool = sum(([t] * c for t, c in counts.items()), [])
    rng.shuffle(pool)
    return _types_to_perm(spec, list(types) + pool)


def _types_to_perm(spec: SystemSpec, types: list[int]) -> np.ndarray:
    """Convert a per-slot type list into a concrete core-id permutation."""
    nxt = {CPU: 0, LLC: spec.n_cpu, GPU: spec.n_cpu + spec.n_llc}
    perm = np.zeros(spec.n_tiles, dtype=np.int32)
    for s, t in enumerate(types):
        perm[s] = nxt[t]
        nxt[t] += 1
    return perm


def _smallworld_adj(spec: SystemSpec, rng: np.random.Generator) -> np.ndarray:
    """Mesh links with a few rewired long-range shortcuts (small-world [5])."""
    d = spec.mesh_design()
    from .problem import absent_planar_pairs, existing_planar_links
    links = existing_planar_links(spec, d.adj)
    holes = absent_planar_pairs(spec, d.adj)
    adj = d.adj.copy()
    for _ in range(max(1, spec.n_planar_links // 8)):
        r = links[rng.integers(len(links))]
        a = holes[rng.integers(len(holes))]
        if adj[r[0], r[1]] and not adj[a[0], a[1]]:
            adj[r[0], r[1]] = adj[r[1], r[0]] = False
            adj[a[0], a[1]] = adj[a[1], a[0]] = True
    return adj


def pcbb(
    spec: SystemSpec,
    ev: Evaluator,
    ctx: PhvContext,
    seed: int = 0,
    *,
    compensation: float = 0.15,
    n_random_rollouts: int = 2,
    link_descent_steps: int = 10,
    max_expansions: int = 200_000,
    history: SearchHistory | None = None,
) -> PcbbResult:
    rng = np.random.default_rng(seed)
    history = history or SearchHistory(ev, ctx)
    mesh_adj = spec.mesh_design().adj
    counts0 = {CPU: spec.n_cpu, LLC: spec.n_llc, GPU: spec.n_gpu}

    best_scal = np.inf
    best_design: Design | None = None
    best_objs: np.ndarray | None = None
    pareto = ParetoSet.empty()
    expanded = pruned = 0

    def bound_of(types: list[int], counts: dict[int, int]) -> float:
        """Roll-out bound: best scalarized completion (greedy/random/SW)."""
        perms = [_complete_greedy(spec, types, counts, rng)]
        for _ in range(n_random_rollouts):
            perms.append(_complete_random(spec, types, counts, rng))
        designs = [Design(p, mesh_adj.copy()) for p in perms]
        designs.append(Design(perms[0], _smallworld_adj(spec, rng)))
        objs = ev.batch(designs)
        scals = [_scalarize(ctx, o) for o in objs]
        j = int(np.argmin(scals))
        nonlocal pareto
        pareto = pareto.merged_with([designs[j]], objs[j][None], ctx.obj_idx)
        for d, o in zip(designs, objs):
            history.record(ev, d, o)
        return scals[j]

    def link_stage(perm: np.ndarray) -> tuple[Design, np.ndarray, float]:
        """Second branching stage, collapsed to a bounded greedy descent over
        link repositions (full link enumeration is astronomically large —
        paper §6.3 C(C(16,2)*4, 96))."""
        from .problem import sample_neighbors
        d = Design(perm, mesh_adj.copy())
        o = ev(d)
        s = _scalarize(ctx, o)
        for _ in range(link_descent_steps):
            cands = [c for c in sample_neighbors(spec, d, rng, 0, 8)]
            if not cands:
                break
            objs = ev.batch(cands)
            scals = np.array([_scalarize(ctx, x) for x in objs])
            j = int(np.argmin(scals))
            if scals[j] >= s:
                break
            d, o, s = cands[j], objs[j], scals[j]
            history.record(ev, d, o)
        return d, o, s

    # Priority: branch higher-prominence types first (LLCs carry >80% of the
    # traffic — §3 — then CPUs, then GPUs).
    type_order = [LLC, CPU, GPU]

    stack: list[tuple[list[int], dict[int, int]]] = [([], counts0)]
    while stack:
        types, counts = stack.pop()
        if expanded >= max_expansions:
            break
        expanded += 1
        if len(types) == spec.n_tiles:
            d, o, s = link_stage(_types_to_perm(spec, types))
            pareto = pareto.merged_with([d], o[None], ctx.obj_idx)
            if s < best_scal:
                best_scal, best_design, best_objs = s, d, o
            continue
        children = []
        for t in type_order:
            if counts.get(t, 0) <= 0:
                continue
            nc = dict(counts)
            nc[t] -= 1
            nt = types + [t]
            b = bound_of(nt, nc)
            # Compensation-adjusted pruning (paper §6.1 / [12]).
            if best_scal < np.inf and b > best_scal * (1.0 + compensation):
                pruned += 1
                continue
            children.append((b, nt, nc))
        # Depth-first, most promising child last (popped first).
        for b, nt, nc in sorted(children, key=lambda z: -z[0]):
            stack.append((nt, nc))

    if best_design is None:
        raise RuntimeError(
            "PCBB found no complete design — raise max_expansions "
            f"(expanded {expanded}, pruned {pruned})")
    return PcbbResult(best_design, best_objs, pareto, expanded, pruned)
