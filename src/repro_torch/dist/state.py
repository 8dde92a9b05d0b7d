"""Resumable per-request sync-round state machine.

:class:`SyncRunState` is the coordinator state of ONE round-based
``stage_dist`` run — everything :func:`repro_torch.dist.sync.run_synced`
keeps between rounds, as an explicit object with a
build/absorb/snapshot/restore protocol:

``build_round(r)``
    Pure planning: the ``run_shard_round`` argument tuples for round
    ``r`` plus the worker ids they belong to (or ``None`` when the run
    is over, or an empty dispatch when every alive worker's cumulative
    budget slice is already spent and the round should be skipped).
``absorb_round(r, dispatched, results, failures)``
    Pool the surviving payloads (sorted worker order — completion order
    must not leak into the shared state), charge budgets, extend the
    failure ledger, drop workers whose retries were exhausted, refresh
    the pooled front; returns whether the run wants another round.
``snapshot(done)`` / ``restore(state)``
    The crash-safe round-checkpoint payload (the format of
    :class:`~repro_torch.dist.ckpt.RoundCheckpointer` files) and its inverse;
    ``restore`` validates the run identity and refuses mismatched runs.

The split is what lets one process drive MANY of these machines over one
shared worker fleet (:mod:`repro_torch.noc.server`): the machine never
dispatches anything itself — the caller owns executors, deadlines,
retries, and fault injection — so requests at different rounds
interleave freely, each advancing whenever *its* round results arrive.
:func:`repro_torch.dist.sync.run_synced` is the single-machine driver of
exactly this protocol, so the interrupt/resume tests (byte identity,
mismatch refusal) pin the shared implementation.
"""

from __future__ import annotations

import numpy as np

from ..core.local_search import ParetoSet
from ..noc.api import Budget, NocProblem, RunResult, design_to_json

from .plan import plan_shards, retry_seed, round_seed, split_evenly

#: history tags are ``worker_id * ROUND_TAG_STRIDE + round`` — unique per
#: (worker, round) and worker-major when sorted. Also the hard cap on
#: rounds (unreachable in practice: every dispatched round costs >= 1
#: evaluation, so rounds are bounded by the eval budget long before it).
ROUND_TAG_STRIDE = 100_000

#: config fields that shape the search trajectory — the run identity a
#: resume must match. Deliberately excludes the knobs that may legally
#: differ between the interrupted and the resuming invocation: executor
#: (where shards run, not what they compute), fault scripts (the resume
#: drops the kill), timeout/retry tuning, and checkpoint_dir/resume
#: themselves.
TRAJECTORY_FIELDS = ("n_workers", "sync_every", "iters_max", "n_starts",
                     "n_swaps", "n_link_moves", "max_local_steps",
                     "forest_kwargs", "forest_backend")


def n_rounds(iters_max: int, sync_every: int) -> int:
    """Planned sync rounds: ceil(iters_max / sync_every). Extra
    budget-draining rounds may follow (see repro_torch.dist.sync)."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    return -(-iters_max // sync_every)


def reseed_round_args(orig_args: tuple, attempt: int) -> tuple:
    """Retry dispatch for attempt ``attempt``: same shard, fresh
    trajectory — only the seed (arg 2, which ``run_shard_round`` folds
    into the budget) changes, via :func:`repro_torch.dist.plan.retry_seed`."""
    return (orig_args[:2] + (retry_seed(orig_args[2], attempt),)
            + orig_args[3:])


class SyncRunState:
    """Coordinator state of one round-based distributed run.

    ``cfg`` is read by attribute (a :class:`repro_torch.noc.optimizers.
    StageDistConfig` or anything exposing the same fields) — this module
    never imports the registry. Construction plans the shards, splits
    the per-worker budgets across the planned rounds, and derives the
    fleet-diversified round-0 starts; nothing is dispatched.
    """

    def __init__(self, problem: NocProblem, budget: Budget, cfg):
        self.problem = problem
        self.budget = budget
        self.cfg = cfg
        self.R = n_rounds(cfg.iters_max, cfg.sync_every)
        self.shards = plan_shards(problem, budget, cfg.n_workers)
        self.round_evals = {s.worker_id: split_evenly(s.budget.max_evals,
                                                     self.R)
                            for s in self.shards}
        self.round_calls = {s.worker_id: split_evenly(s.budget.max_calls,
                                                      self.R)
                            for s in self.shards}
        self.shard_budget = {s.worker_id: s.budget for s in self.shards}
        self.spent_evals = {s.worker_id: 0 for s in self.shards}
        self.spent_calls = {s.worker_id: 0 for s in self.shards}
        self.stage_cfg = {
            "n_starts": cfg.n_starts, "n_swaps": cfg.n_swaps,
            "n_link_moves": cfg.n_link_moves,
            "max_local_steps": cfg.max_local_steps,
            "forest_kwargs": cfg.forest_kwargs,
            "forest_backend": cfg.forest_backend,
        }
        self.problem_json = problem.to_json()
        self.plan_id = {f: getattr(cfg, f) for f in TRAJECTORY_FIELDS}

        self.pooled_x: list[list[float]] = []
        self.pooled_y: list[float] = []
        # The pooled front: the Pareto union of everything any worker
        # found so far, fed back as each next round's global_init.
        self.pooled_front: dict | None = None
        # Round-0 starts mirror stage_batch's chain diversification
        # across the whole fleet: global chain j (worker i, chain k)
        # starts from the mesh perturbed by 2·j random moves, drawn from
        # the root seed. Without this every worker's chain 0 would
        # re-explore the mesh basin W times over — exactly the
        # duplicated work sharding must avoid.
        from ..core.problem import sample_neighbors

        start_rng = np.random.default_rng(budget.seed)
        base = problem.mesh()
        self.starts_by_wid: dict[int, list[dict] | None] = {}
        for s in self.shards:
            chain_starts = []
            for k in range(cfg.n_starts):
                j = s.worker_id * cfg.n_starts + k
                d = base
                for _ in range(2 * j):
                    nb = sample_neighbors(problem.spec, d, start_rng, 1, 1)
                    if nb:
                        d = nb[int(start_rng.integers(len(nb)))]
                chain_starts.append(design_to_json(d))
            self.starts_by_wid[s.worker_id] = chain_starts
        self.alive = [s.worker_id for s in self.shards]
        self.results: list[RunResult] = []
        self.failures: list[dict] = []
        #: round index the next build_round call should use.
        self.next_round = 0
        #: the run has decided to stop (no further rounds may dispatch —
        #: a resume of a finished run must not invent extra rounds).
        self.finished = False
        #: round restored from, for diagnostics (None = fresh run).
        self.resumed_from: int | None = None

    # ------------------------------------------------------------- persist
    def snapshot(self, done: bool) -> dict:
        """Complete coordinator state after a round — everything this
        machine mutates, plus the run identity. ``done`` records whether
        the run had decided to stop (a resume must not dispatch extra
        rounds the uninterrupted run would not have)."""
        return {
            "problem": self.problem_json,
            "budget": self.budget.to_json(),
            "plan": self.plan_id,
            "done": bool(done),
            "alive": list(self.alive),
            "spent_evals": {str(w): v for w, v in self.spent_evals.items()},
            "spent_calls": {str(w): v for w, v in self.spent_calls.items()},
            "starts_by_wid": {str(w): v
                              for w, v in self.starts_by_wid.items()},
            "pooled_x": self.pooled_x,
            "pooled_y": self.pooled_y,
            "pooled_front": self.pooled_front,
            "results": [rr.to_json() for rr in self.results],
            "failures": self.failures,
        }

    def restore(self, state: dict) -> int:
        """Load a :meth:`snapshot` back; validates the run identity and
        returns the restored round index. The machine continues at
        ``next_round = restored + 1``."""
        if (state["problem"] != self.problem_json
                or state["budget"] != self.budget.to_json()
                or state["plan"] != self.plan_id):
            raise ValueError(
                "checkpoint belongs to a different run (problem/budget/"
                "trajectory-config mismatch); refusing to resume")
        self.alive = [int(w) for w in state["alive"]]
        self.spent_evals = {int(w): int(v)
                            for w, v in state["spent_evals"].items()}
        self.spent_calls = {int(w): int(v)
                            for w, v in state["spent_calls"].items()}
        self.starts_by_wid = {int(w): v
                              for w, v in state["starts_by_wid"].items()}
        self.pooled_x = state["pooled_x"]
        self.pooled_y = state["pooled_y"]
        self.pooled_front = state["pooled_front"]
        self.results = [RunResult.from_json(j) for j in state["results"]]
        self.failures = list(state["failures"])
        self.resumed_from = int(state["round"])
        self.next_round = self.resumed_from + 1
        self.finished = bool(state.get("done", False))
        return self.resumed_from

    # -------------------------------------------------------------- rounds
    @property
    def done(self) -> bool:
        """No further rounds may dispatch: the run decided to stop, every
        worker is dead, or the round-tag cap was hit. Callers check this
        BEFORE build_round — a done machine gets no further checkpoint
        saves."""
        return (self.finished or not self.alive
                or self.next_round >= ROUND_TAG_STRIDE)

    def _room(self, wid: int, r: int) -> tuple[int | None, int | None]:
        """Cumulative remaining (evals, calls) for worker ``wid`` at
        round ``r``; extra rounds (r >= R) draw on the full shard."""
        def one(slices, spent, total):
            if total is None:
                return None
            cum = total if r >= self.R else sum(slices[wid][:r + 1])
            return max(0, cum - spent[wid])
        return (one(self.round_evals, self.spent_evals,
                    self.shard_budget[wid].max_evals),
                one(self.round_calls, self.spent_calls,
                    self.shard_budget[wid].max_calls))

    def build_round(self, r: int) -> tuple[list[tuple], list[int]] | None:
        """Argument tuples for round ``r``'s ``run_shard_round``
        dispatches plus the worker ids they belong to, in worker order.

        Returns ``None`` when the run is over (finished, no workers
        alive, round cap hit, or an extra round with no finite eval
        budget to drain). An empty dispatch list means "skip": a planned
        round whose every alive worker's cumulative slice is already
        overspent — later rounds' larger cumulative targets reopen room,
        so the caller should advance to ``r + 1`` without absorbing.
        """
        cfg = self.cfg
        if self.finished or not self.alive or r >= ROUND_TAG_STRIDE:
            self.finished = True
            return None
        planned = r < self.R
        if not planned and self.budget.max_evals is None:
            self.finished = True
            return None  # extra rounds only drain a finite eval budget
        iters_r = (min(cfg.sync_every, cfg.iters_max - r * cfg.sync_every)
                   if planned else cfg.sync_every)
        tasks: list[tuple] = []
        dispatched: list[int] = []
        round_cfg = dict(self.stage_cfg, iters_max=iters_r)
        for wid in self.alive:
            evals_r, calls_r = self._room(wid, r)
            if evals_r == 0 or calls_r == 0:
                continue  # budget fully consumed by earlier rounds
            b = Budget(max_evals=evals_r, max_calls=calls_r,
                       seed=round_seed(self.shard_budget[wid].seed, r))
            starts = self.starts_by_wid[wid]
            if (not planned and self.pooled_front
                    and self.pooled_front["designs"]):
                # Extra rounds intensify: restart every chain from an
                # elite of the pooled front (cycled across workers and
                # rounds for coverage) instead of the meta/random
                # restarts the worker checkpointed — late budget is
                # better spent polishing the union front than opening
                # new basins, which is exactly where the single-process
                # driver's chains sit by this point of a run.
                elite = self.pooled_front["designs"]
                starts = [elite[(wid + k * cfg.n_workers + (r - self.R))
                                % len(elite)]
                          for k in range(cfg.n_starts)]
            dispatched.append(wid)
            tasks.append((
                self.problem_json, b.to_json(), b.seed,
                round_cfg,
                wid * ROUND_TAG_STRIDE + r,        # unique history tag
                starts,
                self.pooled_x or None, self.pooled_y or None,
                self.pooled_front,
            ))
        if not tasks and not planned:
            # In extra rounds room IS the whole remaining shard, so
            # nobody-dispatchable means truly done.
            self.finished = True
            return None
        return tasks, dispatched

    def absorb_round(self, r: int, dispatched: list[int],
                     round_results: dict[int, dict],
                     round_failures: dict[int, list[dict]]) -> bool:
        """Pool round ``r``'s survivors into the shared state; returns
        whether the run wants another round. ``round_results`` /
        ``round_failures`` are keyed by *dispatch index* (position in
        ``dispatched``), exactly as ``execute_shards`` returns them."""
        planned = r < self.R
        # Every failed attempt is reported; a worker is dropped only if
        # it exhausted its attempts (index absent from round_results).
        dropped = []
        for idx in sorted(round_failures):
            self.failures.extend(round_failures[idx])
            if idx not in round_results:
                dropped.append(dispatched[idx])
        # Pool in sorted (worker) order — the shared training set and
        # front must be independent of worker completion order for the
        # next round to be deterministic.
        round_spent = 0
        for idx in sorted(round_results):
            wid = dispatched[idx]
            payload = round_results[idx]
            rr = RunResult.from_json(payload["result"])
            self.spent_evals[wid] += int(rr.n_evals)
            self.spent_calls[wid] += int(rr.n_calls)
            round_spent += int(rr.n_evals)
            self.results.append(rr)
            self.pooled_x.extend(payload["x_train"])
            self.pooled_y.extend(payload["y_train"])
            if payload["next_starts"]:
                self.starts_by_wid[wid] = payload["next_starts"]
        self.alive = [w for w in self.alive if w not in dropped]
        # Refresh the pooled front from every surviving result so far
        # (workers echo the injected front back inside their global
        # sets, so rebuilding from scratch is a pure union, no double
        # counting).
        front = ParetoSet.empty()
        for rr in self.results:
            front = front.merged_with(
                list(rr.designs), np.asarray(rr.objs, dtype=np.float64),
                rr.obj_idx)
        self.pooled_front = {
            "designs": [design_to_json(d) for d in front.designs],
            "objs": np.asarray(front.objs, dtype=np.float64).tolist(),
        }
        # An unplanned round that spent only its mesh anchors made no
        # search progress — further rounds would loop on anchors forever.
        # NOTE: an empty `alive` does NOT flip `cont` here (the next
        # build_round returns None for it) — this keeps the checkpoint
        # `done` flag bit-identical to the reference coordinator's.
        cont = not (not planned and round_spent <= len(dispatched))
        self.finished = not cont
        self.next_round = r + 1
        return cont

    def skip_round(self, r: int) -> bool:
        """Advance past a round with an empty dispatch (every alive
        worker's cumulative slice overspent). Planned rounds continue —
        later rounds reopen room; extra rounds end the run."""
        planned = r < self.R
        self.finished = not planned
        self.next_round = r + 1
        return planned
