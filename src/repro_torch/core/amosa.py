"""AMOSA — Archived Multi-Objective Simulated Annealing (Bandyopadhyay et
al. [10]), the paper's primary baseline (§6.1).

Implements the standard acceptance logic based on the *amount of domination*

    Δdom(a, b) = Π_{i: f_i differs}  |f_i(a) - f_i(b)| / R_i

(objectives normalized by the PHV context so R_i is the mesh-design scale),
with an archive kept non-dominated and thinned to the hard limit by
crowding-distance when it exceeds the soft limit (stand-in for AMOSA's
clustering step).

Candidate scoring is batched two ways: the per-candidate archive scan
(dominance test + Δdom against every archive member) is one vectorized
numpy pass instead of a Python loop, and with ``block_size > 1`` neighbor
proposals are evaluated speculatively in blocks through
``Evaluator.batch`` — the SA chain consumes pre-evaluated candidates one
by one while the current design is unchanged and discards the rest of the
block on acceptance (the chain itself stays exactly sequential). The
default is ``block_size=1``: discarded speculative evaluations count
against ``max_evals``, so eval-budgeted baseline comparisons (Table 2 /
Fig. 6) keep the sequential chain's exact accounting; raise it when
wall-clock matters more than the budget bookkeeping.

``adaptive_block=True`` reclaims most of the speculation waste: the block
shrinks (halves) every time a proposal is accepted — while acceptance is
hot, speculated candidates are usually discarded — and grows (doubles, up
to ``block_max``) after a full block is consumed without an acceptance, as
the cooling chain settles into long rejection runs where speculation is
nearly free. Blocks are additionally clipped to the remaining ``max_evals``
budget, so an adaptive run never evaluates past its budget."""

from __future__ import annotations

import numpy as np

from .evaluate import Evaluator
from .local_search import ParetoSet, SearchHistory
from .pareto import PhvContext, crowding_thin, dominates
from .problem import Design, SystemSpec, sample_neighbors


def _delta_dom(a: np.ndarray, b: np.ndarray) -> float:
    d = np.abs(a - b)
    d = d[d > 1e-15]
    return float(np.prod(d)) if d.size else 0.0


def _delta_dom_rows(arch: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise Δdom(arch[i], b) — the vectorized form of
    :func:`_delta_dom` (filling ignored coords with 1.0 keeps the product
    bit-equal; rows with no differing coordinate score 0.0)."""
    d = np.abs(arch - b[None, :])
    differs = d > 1e-15
    prod = np.prod(np.where(differs, d, 1.0), axis=1)
    return np.where(differs.any(axis=1), prod, 0.0)


def amosa(
    spec: SystemSpec,
    ev: Evaluator,
    ctx: PhvContext,
    d0: Design,
    seed: int = 0,
    *,
    t_max: float = 1.0,
    t_min: float = 1e-4,
    alpha: float = 0.92,
    iters_per_temp: int = 40,
    soft_limit: int = 40,
    hard_limit: int = 24,
    max_evals: int | None = None,
    history: SearchHistory | None = None,
    block_size: int = 1,
    adaptive_block: bool = False,
    block_max: int = 16,
) -> ParetoSet:
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    rng = np.random.default_rng(seed)
    history = history or SearchHistory(ev, ctx)

    cur = d0
    cur_obj = ev(cur)
    history.record(ev, cur, cur_obj)
    archive = ParetoSet.empty().merged_with([cur], cur_obj[None], ctx.obj_idx)
    block: list[tuple[Design, np.ndarray]] = []
    # Adaptive mode starts from the configured block_size (default 1) and
    # moves within [1, block_max] as the acceptance rate evolves.
    cur_block = min(block_size, block_max) if adaptive_block else block_size
    rejects_in_row = 0  # consecutive rejections since the last acceptance

    temp = t_max
    while temp > t_min:
        for _ in range(iters_per_temp):
            if max_evals is not None and ev.n_evals >= max_evals:
                return archive
            if not block:
                # Speculatively evaluate a block of neighbors of ``cur`` in
                # one padded batch; they stay valid proposals until ``cur``
                # changes (acceptance clears the block below).
                bs = cur_block
                if max_evals is not None:
                    bs = min(bs, max_evals - ev.n_evals)  # never overshoot
                props: list[Design] = []
                for _ in range(bs):
                    cands = sample_neighbors(spec, cur, rng, 1, 1)
                    if cands:
                        props.append(cands[rng.integers(len(cands))])
                if not props:
                    continue
                objs = ev.batch(props)
                for d, o in zip(props, objs):
                    history.record(ev, d, o)
                block = list(zip(props, objs))
            new, new_obj = block.pop(0)

            a_n = ctx.normalize(new_obj)
            a_c = ctx.normalize(cur_obj)
            arch_n = ctx.normalize(archive.objs)

            # Vectorized archive scan: which members dominate the candidate,
            # and their amounts of domination — one pass, no Python loop.
            dom_new_by = np.flatnonzero(
                np.all(arch_n <= a_n, axis=1) & np.any(arch_n < a_n, axis=1))
            accepted = False
            if dominates(a_c, a_n):
                # Case 1: current dominates new — probabilistic acceptance.
                ddoms = np.append(_delta_dom_rows(arch_n[dom_new_by], a_n),
                                  _delta_dom(a_c, a_n))
                davg = float(np.mean(ddoms))
                if rng.random() < 1.0 / (1.0 + np.exp(min(davg / max(temp, 1e-9), 50.0))):
                    cur, cur_obj = new, new_obj
                    accepted = True
            elif dom_new_by.size:
                # Case 2a: new dominated by archive points.
                davg = float(np.mean(_delta_dom_rows(arch_n[dom_new_by], a_n)))
                if rng.random() < 1.0 / (1.0 + np.exp(min(davg / max(temp, 1e-9), 50.0))):
                    cur, cur_obj = new, new_obj
                    accepted = True
            else:
                # Case 2b/3: new is non-dominated w.r.t. archive (it may
                # dominate some archive members) — accept and archive it.
                cur, cur_obj = new, new_obj
                accepted = True
                archive = archive.merged_with([new], new_obj[None], ctx.obj_idx)
                if len(archive.designs) > soft_limit:
                    keep = crowding_thin(
                        ctx.normalize(archive.objs), hard_limit
                    )
                    archive = ParetoSet(
                        [archive.designs[i] for i in keep], archive.objs[keep]
                    )
            if accepted:
                block.clear()  # remaining proposals are stale neighbors
                rejects_in_row = 0
                if adaptive_block:
                    # Acceptance is hot: speculated evals mostly get thrown
                    # away, so shrink the next block.
                    cur_block = max(1, cur_block // 2)
            else:
                rejects_in_row += 1
                if adaptive_block and rejects_in_row >= cur_block:
                    # A full block survived without acceptance — the chain
                    # is cooling; speculate deeper next time.
                    cur_block = min(block_max, cur_block * 2)
                    rejects_in_row = 0
        temp *= alpha
    return archive
