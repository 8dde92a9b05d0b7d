"""Algorithm 1 — PHV-greedy local search.

From a starting design, repeatedly evaluate a (sampled) neighborhood in one
batched evaluator call, move to the neighbor maximizing PHV(S_local ∪ {d}), and
stop when the best neighbor no longer improves the PHV. Returns the local
non-dominated set, the search trajectory, and the last design (Alg. 1's
(S_local, S_traj, d_last)).

:func:`local_search_batch` runs K chains in lockstep: per step, every live
chain samples its neighborhood and ALL candidates go through one
``Evaluator.batch_moves`` call (one batched device pass serves every
chain), then each chain takes its own greedy PHV step. ``local_search`` is
the K=1 special case."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .evaluate import Evaluator
from .pareto import ParetoArchive, PhvContext, crowding_thin
from .problem import Design, SystemSpec, sample_neighbor_moves
from ..tracing import span


def _front_keep(sub: np.ndarray, n_front: int) -> np.ndarray:
    """Keep mask over the rows of ``sub``: the first ``n_front``, already a
    non-dominated deduplicated front, seed a :class:`ParetoArchive`
    unchecked; each later row is inserted in order, clearing the rows it
    evicts."""
    arch = ParetoArchive.from_front(sub[:n_front], tags=range(n_front))
    keep = np.zeros(len(sub), dtype=bool)
    keep[:n_front] = True
    for i in range(n_front, len(sub)):
        ok, evicted = arch.insert(sub[i], tag=i)
        keep[i] = ok
        for t in evicted:
            keep[t] = False
    return keep


@dataclasses.dataclass
class ParetoSet:
    """A set of designs + their (full 5-dim) objective rows, non-dominated
    under the active objective subset."""

    designs: list[Design]
    objs: np.ndarray  # (n, 5)

    @staticmethod
    def empty() -> "ParetoSet":
        return ParetoSet([], np.zeros((0, 5)))

    def sub(self, obj_idx) -> np.ndarray:
        return self.objs[:, list(obj_idx)] if len(self.designs) else self.objs

    def merged_with(self, designs: list[Design], objs: np.ndarray,
                    obj_idx) -> "ParetoSet":
        """Pareto union with new (design, objective-row) pairs.

        Incremental: ``self`` is by construction an already-non-dominated,
        deduplicated front (every ParetoSet is produced by a previous merge
        under the same ``obj_idx``), so it seeds a :class:`ParetoArchive`
        unchecked and only the *new* rows pay an O(front·k) insertion each
        — no O(n²·k) dominance cube. Output rows keep stacked order
        (surviving old rows, then accepted new rows), byte-identical to the
        historical ``pareto_mask`` implementation."""
        alld = self.designs + list(designs)
        if not alld:
            return ParetoSet.empty()
        allo = np.vstack([self.objs, np.atleast_2d(objs)])
        keep = _front_keep(allo[:, list(obj_idx)], len(self.designs))
        return ParetoSet([d for d, m in zip(alld, keep) if m], allo[keep])

    @staticmethod
    def canonical_union(sets: "list[ParetoSet]", obj_idx) -> "ParetoSet":
        """Order-independent Pareto union: a pure function of the input
        *set* of (design, objectives) pairs — any permutation of ``sets``
        (or of the rows inside them) yields bit-identical output.

        ``merged_with`` accumulates in arrival order, and ``pareto_mask``
        keeps the *first* of exact-tied rows, so which tied design
        survives depends on that order. Here all pairs are deduplicated
        and canonically sorted by (objective row, design key) before the
        mask runs — the determinism a distributed merge needs when worker
        results arrive in pool-completion order (repro.dist.merge)."""
        pairs: dict[tuple, tuple] = {}
        for ps in sets:
            objs = np.asarray(ps.objs, dtype=np.float64)
            for d, o in zip(ps.designs, objs):
                pairs.setdefault((tuple(o.tolist()), d.key()), (d, o))
        if not pairs:
            return ParetoSet.empty()
        order = sorted(pairs)
        designs = [pairs[k][0] for k in order]
        objs = np.stack([pairs[k][1] for k in order])
        keep = _front_keep(objs[:, list(obj_idx)], 0)
        return ParetoSet([d for d, m in zip(designs, keep) if m], objs[keep])

    def keys(self) -> set[bytes]:
        return {d.key() for d in self.designs}


@dataclasses.dataclass
class LocalResult:
    local: ParetoSet
    traj: list[Design]
    traj_objs: np.ndarray
    d_last: Design
    phv: float
    n_steps: int


def local_search(
    spec: SystemSpec,
    ev: Evaluator,
    ctx: PhvContext,
    d_start: Design,
    rng: np.random.Generator,
    *,
    n_swaps: int = 24,
    n_link_moves: int = 24,
    max_steps: int = 10_000,
    max_set: int = 24,
    history: "SearchHistory | None" = None,
    max_evals: int | None = None,
) -> LocalResult:
    return local_search_batch(
        spec, ev, ctx, [d_start], rng,
        n_swaps=n_swaps, n_link_moves=n_link_moves, max_steps=max_steps,
        max_set=max_set, history=history, max_evals=max_evals,
    )[0]


class _Chain:
    """Mutable per-chain state for the lockstep driver."""

    __slots__ = ("s_local", "traj", "traj_objs", "d_curr", "phv", "active",
                 "n_steps")

    def __init__(self, d0: Design, objs0: np.ndarray, ctx: PhvContext,
                 seed_set: "ParetoSet | None" = None):
        base = seed_set if seed_set is not None else ParetoSet.empty()
        self.s_local = base.merged_with([d0], objs0[None], ctx.obj_idx)
        self.traj = [d0]
        self.traj_objs = [objs0]
        self.d_curr = d0
        self.phv = ctx.phv(self.s_local.objs)
        self.active = True
        self.n_steps = 0


def local_search_batch(
    spec: SystemSpec,
    ev: Evaluator,
    ctx: PhvContext,
    starts: list[Design],
    rng: np.random.Generator,
    *,
    n_swaps: int = 24,
    n_link_moves: int = 24,
    max_steps: int = 10_000,
    max_set: int = 24,
    history: "SearchHistory | None" = None,
    max_evals: int | None = None,
    seed_set: "ParetoSet | None" = None,
) -> list[LocalResult]:
    """K PHV-greedy local searches advanced in lockstep (one
    ``Evaluator.batch_moves`` call per step serves every live chain). With a
    single start this IS ``local_search`` — the rng stream, greedy argmax,
    and thinning are identical. ``max_evals`` stops launching new steps once
    the evaluator's counter crosses the budget (multi-start accounting).

    ``seed_set`` (e.g. the global non-dominated set of a multi-start driver)
    pre-populates every chain's working set, so each chain greedily maximizes
    its *marginal* PHV over what is already known — chains coordinate toward
    complementary regions instead of re-finding the same tradeoffs."""
    start_objs = ev.batch(starts)
    with span("noc.ls.start"):
        chains = [_Chain(d0, o, ctx, seed_set)
                  for d0, o in zip(starts, start_objs)]

    for step in range(1, max_steps + 1):
        if max_evals is not None and ev.n_evals >= max_evals:
            break
        with span("noc.ls.sample"):
            move_lists: list = []
            for ch in chains:
                if not ch.active:
                    move_lists.append(None)
                    continue
                ch.n_steps = step
                # Neighborhoods stay in move form: the evaluator can serve
                # them from incremental table deltas (Evaluator.batch_moves
                # — at spec_large scale each candidate costs an O(N²) table
                # update instead of a full APSP), and only the per-chain
                # winning move is ever materialized as a Design.
                mv = sample_neighbor_moves(spec, ch.d_curr, rng, n_swaps,
                                           n_link_moves)
                if not len(mv):
                    ch.active = False
                    move_lists.append(None)
                    continue
                move_lists.append(mv)
        live = [mv for mv in move_lists if mv is not None]
        if not live:
            break
        objs_all = ev.batch_moves(live)
        ofs = 0
        for ch, mv in zip(chains, move_lists):
            if mv is None:
                continue
            objs = objs_all[ofs:ofs + len(mv)]
            ofs += len(mv)
            if not ch.active:
                continue
            # argmax_d PHV(S_local ∪ {d}) — Alg. 1 line 3, scored for the
            # whole neighborhood in one batched exclusive-contribution pass.
            with span("noc.ls.score"):
                phvs = ctx.phv_with_batch(ch.s_local.objs, objs)
                j = int(np.argmax(phvs))
            if phvs[j] <= ch.phv + 1e-12:
                ch.active = False
                continue
            with span("noc.ls.keep"):
                ch.d_curr = mv.materialize(j)
                ev.note_accept(mv, j)
                ch.s_local = ch.s_local.merged_with(
                    [ch.d_curr], objs[j][None], ctx.obj_idx)
                ch.phv = phvs[j]
                if len(ch.s_local.designs) > max_set:
                    # Bound the PHV working set (crowding thinning, as
                    # AMOSA bounds its archive) — HSO cost grows fast with
                    # set size.
                    keep = crowding_thin(
                        ctx.normalize(ch.s_local.objs), max_set * 2 // 3)
                    ch.s_local = ParetoSet(
                        [ch.s_local.designs[i] for i in keep],
                        ch.s_local.objs[keep])
                    # Re-anchor the greedy bar to the thinned set:
                    # candidates are scored against it, so keeping the
                    # pre-thinning PHV would set an unattainable bar and
                    # stall the chain.
                    ch.phv = ctx.phv(ch.s_local.objs)
                ch.traj.append(ch.d_curr)
                ch.traj_objs.append(objs[j])
                if history is not None:
                    history.record(ev, ch.d_curr, objs[j])
        if not any(ch.active for ch in chains):
            break

    return [
        LocalResult(
            local=ch.s_local,
            traj=ch.traj,
            traj_objs=np.stack(ch.traj_objs),
            d_last=ch.d_curr,
            phv=ch.phv,
            n_steps=ch.n_steps,
        )
        for ch in chains
    ]


class SearchHistory:
    """Convergence trace: (wall time, #evaluations, best-so-far EDP, PHV).

    Used by the Fig. 6 / Table 2 benchmarks to compare optimizers on equal
    footing (both wall-clock and evaluation count). PHV per record is
    expensive (recursive HSO); it is only computed when ``track_phv``."""

    def __init__(self, ev: Evaluator, ctx: PhvContext,
                 track_phv: bool = False):
        self.t0 = time.perf_counter()
        self.ctx = ctx
        self.track_phv = track_phv
        self.rows: list[tuple[float, int, float, float]] = []
        self.best_edp = np.inf
        # Incremental best-so-far front: each record pays one O(front·k)
        # archive insertion instead of rebuilding pareto_mask's O(n²·k)
        # dominance cube over the accumulated rows. Tags carry the full
        # 5-dim rows (the archive itself only sees the active subset).
        self._arch = ParetoArchive(len(ctx.obj_idx))

    def record(self, ev: Evaluator, d: Design, objs: np.ndarray):
        edp = float(objs[2] * objs[3])  # cpu-llc latency x energy (analytic)
        self.best_edp = min(self.best_edp, edp)
        phv = np.nan
        if self.track_phv:
            full = np.asarray(objs, dtype=np.float64).copy()
            self._arch.insert(full[list(self.ctx.obj_idx)], tag=full)
            phv = self.ctx.phv(np.stack(self._arch.tags))
        self.rows.append(
            (time.perf_counter() - self.t0, ev.n_evals, self.best_edp, phv)
        )

    def as_array(self) -> np.ndarray:
        return np.asarray(self.rows, dtype=np.float64).reshape(-1, 4)
