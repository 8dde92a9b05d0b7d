"""Shard planning for distributed multi-start MOO-STAGE.

One global ``(NocProblem, Budget)`` pair is split into W worker shards.
Each shard is again a plain ``(problem, budget, seed)`` triple — the same
serializable boundary :mod:`repro_torch.noc.api` defines for a single run —
so a shard can execute anywhere a :func:`repro_torch.dist.worker.run_shard`
call can be dispatched (in-process, a subprocess, another host).

Two invariants the test suite pins:

* **Remainder-exact budgets** — :func:`split_evenly` distributes
  ``total`` over ``k`` parts such that the parts sum to exactly ``total``
  (low indices absorb the remainder). Σ worker ``max_evals`` therefore
  equals the global ``max_evals``; no evaluation budget is silently
  created or destroyed by sharding.
* **Identity at W=1** — a single-shard plan passes the root seed and the
  full budget through unchanged, which is what makes
  ``stage_dist(executor="serial", n_workers=1)`` reproduce a registry
  ``stage_batch`` run bit-for-bit. For W>1 the per-worker seeds are
  derived from the root seed via ``numpy.random.SeedSequence.spawn`` —
  statistically independent streams, deterministic in the root seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..noc.api import Budget, NocProblem


def split_evenly(total: int | None, k: int) -> list[int | None]:
    """Split ``total`` into ``k`` non-negative parts summing exactly to
    ``total`` (parts ``i < total % k`` get one extra). ``None`` (no limit)
    splits into ``k`` ``None``s."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if total is None:
        return [None] * k
    if total < 0:
        raise ValueError(f"total must be >= 0, got {total}")
    base, rem = divmod(total, k)
    return [base + (1 if i < rem else 0) for i in range(k)]


def spawn_seeds(root_seed: int, n_workers: int) -> list[int]:
    """Per-worker seeds derived from ``root_seed``.

    W=1 is the identity plan (the root seed passes through — the W=1
    serial-equivalence pin depends on this); W>1 spawns independent
    ``SeedSequence`` children and folds each into one Python int."""
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if n_workers == 1:
        return [int(root_seed)]
    children = np.random.SeedSequence(root_seed).spawn(n_workers)
    return [int(c.generate_state(1, np.uint32)[0]) for c in children]


def round_seed(worker_seed: int, round_idx: int) -> int:
    """Deterministic per-(worker, sync round) seed. Round 0 is the worker
    seed itself (so the no-sync path and round 0 of a synced run share
    streams); later rounds fold the round index through a SeedSequence."""
    if round_idx == 0:
        return int(worker_seed)
    ss = np.random.SeedSequence([int(worker_seed), int(round_idx)])
    return int(ss.generate_state(1, np.uint32)[0])


#: spawn-key tag distinguishing retry streams from round streams: without
#: it ``retry_seed(s, k)`` would collide with ``round_seed(s, k)`` and a
#: retried round-0 dispatch would replay round k's trajectory.
_RETRY_TAG = 0x52455452  # "RETR"


def retry_seed(dispatch_seed: int, attempt: int) -> int:
    """Deterministic per-attempt seed for a retried shard dispatch.

    Attempt 0 is the dispatch seed itself (the no-fault path is
    untouched); attempt ``a`` >= 1 folds the attempt index through a
    tagged SeedSequence — a retried shard samples a *different*
    trajectory rather than deterministically replaying the inputs that
    just crashed or hung."""
    if attempt < 0:
        raise ValueError(f"attempt must be >= 0, got {attempt}")
    if attempt == 0:
        return int(dispatch_seed)
    ss = np.random.SeedSequence([int(dispatch_seed), _RETRY_TAG, int(attempt)])
    return int(ss.generate_state(1, np.uint32)[0])


@dataclasses.dataclass(frozen=True)
class Shard:
    """One worker's unit of work: (problem, budget) with the worker's own
    seed folded into the budget. Everything here JSON-serializes, so a
    shard crosses a process (or host) boundary as three small dicts."""

    worker_id: int
    problem: NocProblem
    budget: Budget

    def to_json(self) -> dict:
        return {"worker_id": self.worker_id,
                "problem": self.problem.to_json(),
                "budget": self.budget.to_json()}


def plan_shards(problem: NocProblem, budget: Budget,
                n_workers: int) -> list[Shard]:
    """Split one global ``(problem, budget)`` into ``n_workers`` shards.

    ``max_evals`` and ``max_calls`` are divided remainder-exactly
    (Σ shard budget == global budget); seeds come from
    :func:`spawn_seeds`. Every shard shares the problem object — it is
    immutable and serialized once per dispatch."""
    evals = split_evenly(budget.max_evals, n_workers)
    calls = split_evenly(budget.max_calls, n_workers)
    seeds = spawn_seeds(budget.seed, n_workers)
    return [
        Shard(worker_id=i, problem=problem,
              budget=Budget(max_evals=evals[i], max_calls=calls[i],
                            seed=seeds[i]))
        for i in range(n_workers)
    ]
