"""Per-round surrogate + front sync across workers.

``stage_batch`` shares one surrogate and one global front across its K
in-process chains; this module generalizes both tricks across
*processes*. The run is cut into rounds of ``sync_every`` STAGE
iterations:

1. every worker runs ``sync_every`` iterations of its chains
   (:func:`repro_torch.dist.worker.run_shard_round`) and checkpoints the
   ``(X, y)`` surrogate training rows its trajectories produced plus the
   designs its chains would restart from;
2. the coordinator pools all workers' rows into one shared training set
   and all workers' Pareto sets into one pooled front;
3. the next round resumes every worker's chains from their checkpointed
   starts with the pooled rows fitted into a warm surrogate
   (``stage_batch(train_init=...)``) and the pooled front seeded as the
   global set (``global_init=``) — each worker's meta-search is steered
   by what *every* worker learned (DAgger across the fleet), and each
   chain maximizes *marginal* PHV over the fleet's whole front instead
   of re-finding another worker's tradeoffs.

Budget accounting is cumulative and remainder-exact: the global
``max_evals`` splits across workers, each worker's share splits across
its first ``ceil(iters_max / sync_every)`` rounds, and round r may spend
up to its cumulative slice minus what the worker actually spent — search
drivers check budgets *before* a dispatch, so charging cumulatively
bounds a worker at shard budget + one dispatch total instead of + one
dispatch per round, and hands budget an early-converged round left to
the rounds after it. Once the planned rounds are done, the coordinator
keeps dispatching **extra rounds** (fresh ``sync_every``-iteration
resumptions) while eval budget remains and the previous round still made
search progress — the eval budget is the contract, iteration counts are
per-round structure. Each round runs on a fresh per-round evaluator
(process workers cannot carry evaluator state between rounds), so each
round's mesh-anchor evaluation is paid inside its slice, like any other
evaluation.

All of the per-round planning/pooling state lives in
:class:`repro_torch.dist.state.SyncRunState` (build_round / absorb_round /
snapshot / restore) — :func:`run_synced` is the single-machine driver of
that protocol, and :mod:`repro_torch.noc.server` drives many machines over
one shared fleet.

Resilience: dispatches carry per-shard deadlines and bounded reseeded
retries (``cfg.shard_timeout_s`` / ``max_retries`` / ``retry_backoff_s``
threaded into :func:`repro_torch.dist.worker.execute_shards`); payloads
are structurally validated before pooling; a worker whose attempts are
exhausted in round r is dropped from later rounds (its earlier rounds'
results still merge); every failed attempt is reported as a structured
record. With ``cfg.checkpoint_dir`` set, the coordinator persists its
complete state after every round
(:class:`repro_torch.dist.ckpt.RoundCheckpointer`, atomic tmp → fsync →
rename) and ``cfg.resume=True`` restores it — an interrupted-then-resumed
run is byte-identical to the uninterrupted one. Scripted faults
(``cfg.faults``) exercise all of it deterministically.
"""

from __future__ import annotations

from ..noc.api import Budget, NocProblem, RunResult
from .ckpt import RoundCheckpointer
from .faults import CoordinatorKilled, FaultInjector
from .state import (ROUND_TAG_STRIDE, TRAJECTORY_FIELDS,  # noqa: F401
                    SyncRunState, n_rounds, reseed_round_args)


def validate_round_payload(payload) -> None:
    """Structural check on a worker's round payload before it is pooled —
    the coordinator's defense against corrupt/truncated returns (an
    injected ``corrupt`` fault lands here, phase ``"validate"``)."""
    if not isinstance(payload, dict):
        raise ValueError(f"round payload must be a dict, "
                         f"got {type(payload).__name__}")
    missing = {"result", "x_train", "y_train", "next_starts"} - set(payload)
    if missing:
        raise ValueError(f"round payload missing keys {sorted(missing)}")
    result = payload["result"]
    if not isinstance(result, dict) or not {"designs", "objs",
                                            "n_evals"} <= set(result):
        raise ValueError("round payload 'result' is not a RunResult JSON")


def run_synced(problem: NocProblem, budget: Budget, cfg, device: str,
               ) -> tuple[list[RunResult], list[dict], dict]:
    """Execute the round-based synced run on ``device``; returns
    ``(results, failures, info)`` where ``results`` are one RunResult per
    surviving (worker, round) — history-tagged ``worker_id *
    ROUND_TAG_STRIDE + round`` so the merge orders histories by worker then
    round — ``failures`` are structured per-attempt records (worker_id,
    round, attempt, phase, error, traceback), and ``info`` carries
    resilience diagnostics (pool_rebuilds, checkpoint stats,
    resumed_from_round).

    ``cfg`` is the :class:`repro_torch.noc.optimizers.StageDistConfig`
    (only its fields are read; no import, so repro_torch.dist never imports
    the registry at module scope)."""
    from . import worker as _worker

    sm = SyncRunState(problem, budget, cfg)

    faults = tuple(getattr(cfg, "faults", ()) or ())
    injector = FaultInjector(faults=faults) if faults else None
    timeout_s = getattr(cfg, "shard_timeout_s", None)
    max_retries = int(getattr(cfg, "max_retries", 0) or 0)
    backoff_s = float(getattr(cfg, "retry_backoff_s", 0.0) or 0.0)

    # ------------------------------------------------------ checkpointing
    ckpt: RoundCheckpointer | None = None
    if getattr(cfg, "checkpoint_dir", None):
        ckpt = RoundCheckpointer(cfg.checkpoint_dir)
        if getattr(cfg, "resume", False):
            try:
                sm.restore(ckpt.load_round())
            except ValueError as exc:
                raise ValueError(
                    f"checkpoint in {cfg.checkpoint_dir!r}: {exc}") from exc

    info: dict = {"pool_rebuilds": 0, "resumed_from_round": sm.resumed_from,
                  "checkpoint": None}

    # One pool for every round: spawn children pay their interpreter +
    # torch import once; a broken pool is killed and rebuilt by
    # execute_shards, charging the in-flight shards a retry.
    with _worker.shard_pool(cfg.executor, cfg.n_workers, device) as pool:
        try:
            while not sm.done:
                r = sm.next_round
                built = sm.build_round(r)
                if built is None:
                    cont = False          # the round decided: run over
                elif not built[0]:
                    cont = sm.skip_round(r)
                else:
                    tasks, dispatched = built
                    round_results, round_failures = _worker.execute_shards(
                        _worker.run_shard_round, tasks, cfg.executor,
                        pool=pool, device=device,
                        meta=[(wid, r) for wid in dispatched],
                        timeout_s=timeout_s, max_retries=max_retries,
                        backoff_s=backoff_s, retry_args=reseed_round_args,
                        injector=injector, validate=validate_round_payload)
                    cont = sm.absorb_round(r, dispatched, round_results,
                                           round_failures)
                if ckpt is not None:
                    ckpt.save_round(r, sm.snapshot(done=not cont))
                if injector is not None and injector.kills_coordinator(r):
                    saved = "saved" if ckpt is not None else "NOT saved"
                    raise CoordinatorKilled(
                        f"injected coordinator kill after round {r} "
                        f"(checkpoint {saved})")
                if not cont:
                    break
        finally:
            if isinstance(pool, _worker.ShardPool):
                info["pool_rebuilds"] = pool.rebuilds
    if ckpt is not None:
        info["checkpoint"] = {"dir": ckpt.dir, "n_saves": ckpt.n_saves,
                              "save_s": ckpt.save_s,
                              "rounds_on_disk": ckpt.rounds()}

    return sm.results, sm.failures, info
