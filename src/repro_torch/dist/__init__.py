"""``repro_torch.dist`` — distributed multi-start MOO-STAGE.

Shards one global ``(NocProblem, Budget)`` across W workers
(:mod:`~repro_torch.dist.plan`), executes each shard as a pure
JSON-boundary function (:mod:`~repro_torch.dist.worker` — in-process, in a
spawn process pool, or one shard per CUDA device), merges the worker
``RunResult``s by worker-order-independent Pareto union
(:mod:`~repro_torch.dist.merge`), and optionally pools surrogate training
rows between rounds (:mod:`~repro_torch.dist.sync`).

Entry point: :func:`run_dist` — registered in the optimizer registry as
``"stage_dist"`` (``python -m repro_torch.noc run --optimizer stage_dist
--workers K``). It runs on the device :func:`repro_torch.noc.run` is given
(``"cuda"`` unless told otherwise; it raises without a card).

Fault tolerance: every failed dispatch attempt — worker exception,
deadline trip, pool breakage, rejected payload — is recorded as a
structured record in the merged result's ``extra["worker_failures"]``;
shards get bounded, reseeded retries; the spawn pool is rebuilt on
breakage; synced runs can checkpoint coordinator state each round and
resume after a crash. The coordinator returns the Pareto union of the
survivors; only a run with *zero* surviving workers raises.
"""

from __future__ import annotations

import dataclasses
import time

from ..noc.api import Budget, NocProblem, RunResult
from .ckpt import RoundCheckpointer
from .faults import (CORRUPT_PAYLOAD, SERVICE_FAULT_KINDS, CoordinatorKilled,
                     FaultInjector, InjectedFault, ServerKilled, check_faults)
from .merge import merge_results, merged_pareto
from .plan import (Shard, plan_shards, retry_seed, round_seed, spawn_seeds,
                   split_evenly)
from .state import SyncRunState
from .sync import n_rounds, run_synced, validate_round_payload
from .worker import (EXECUTORS, ShardPool, check_executor, execute_shards,
                     run_shard, shard_pool)

__all__ = [
    "CORRUPT_PAYLOAD", "CoordinatorKilled", "EXECUTORS", "FaultInjector",
    "InjectedFault", "RoundCheckpointer", "SERVICE_FAULT_KINDS",
    "ServerKilled", "Shard", "ShardPool", "SyncRunState", "check_executor",
    "check_faults", "execute_shards", "merge_results", "merged_pareto",
    "n_rounds", "package_dist_result", "plan_shards", "retry_seed",
    "round_seed", "run_dist", "run_shard", "run_synced", "shard_pool",
    "spawn_seeds", "split_evenly", "validate_round_payload",
]


def _stage_config_json(cfg) -> dict:
    """The worker-side ``StageBatchConfig`` overrides carried by a
    :class:`~repro_torch.noc.optimizers.StageDistConfig`."""
    return {
        "n_starts": cfg.n_starts, "iters_max": cfg.iters_max,
        "n_swaps": cfg.n_swaps, "n_link_moves": cfg.n_link_moves,
        "max_local_steps": cfg.max_local_steps,
        "forest_kwargs": cfg.forest_kwargs,
        "forest_backend": cfg.forest_backend,
        "meta_backend": cfg.meta_backend,
    }


def run_dist(problem: NocProblem, budget: Budget, cfg,
             device=None) -> RunResult:
    """Coordinate one distributed multi-start run on ``device`` (default
    ``"cuda"``; raises when no card is present); returns the merged
    :class:`RunResult` (optimizer ``"stage_dist"``).

    ``cfg`` is a :class:`repro_torch.noc.optimizers.StageDistConfig` (read
    by attribute — this module never imports the registry, the registry
    imports us lazily). With ``sync_every == 0`` every worker runs its
    whole shard independently (one ``stage_batch`` registry run each);
    with ``sync_every > 0`` the run proceeds in surrogate-sync rounds
    (see :mod:`repro_torch.dist.sync`). The coordinator builds no
    evaluator of its own except the one that anchors the merged PHV.

    The W=1 ``serial`` run is the identity: one shard carrying the root
    seed and the full budget through the same ``api.run`` path a direct
    registry ``stage_batch`` call takes — byte-identical payload.
    """
    from ..device import resolve_device
    from . import worker as _worker  # attribute lookup at call time so
    #                                  monkeypatched run_shard is honored

    check_executor(cfg.executor)
    dev = str(resolve_device(device))
    t0 = time.perf_counter()
    shards = plan_shards(problem, budget, cfg.n_workers)

    dist_info: dict = {"pool_rebuilds": 0, "resumed_from_round": None,
                       "checkpoint": None}
    if cfg.sync_every > 0:
        results, failure_rows, dist_info = run_synced(problem, budget, cfg,
                                                      dev)
    else:
        stage_cfg = _stage_config_json(cfg)
        tasks = [(s.problem.to_json(), s.budget.to_json(), s.budget.seed,
                  stage_cfg, s.worker_id) for s in shards]
        faults = tuple(getattr(cfg, "faults", ()) or ())
        injector = FaultInjector(faults=faults) if faults else None

        def _reseed(orig_args, attempt):
            # Same shard, fresh trajectory: only the dispatch seed moves.
            return (orig_args[:2] + (retry_seed(orig_args[2], attempt),)
                    + orig_args[3:])

        with _worker.shard_pool(cfg.executor, cfg.n_workers, dev) as pool:
            raw, failures = _worker.execute_shards(
                _worker.run_shard, tasks, cfg.executor, pool=pool,
                device=dev, meta=[(s.worker_id, 0) for s in shards],
                timeout_s=getattr(cfg, "shard_timeout_s", None),
                max_retries=int(getattr(cfg, "max_retries", 0) or 0),
                backoff_s=float(getattr(cfg, "retry_backoff_s", 0.0) or 0.0),
                retry_args=_reseed, injector=injector,
                validate=_worker.validate_result_payload)
            if isinstance(pool, _worker.ShardPool):
                dist_info["pool_rebuilds"] = pool.rebuilds
        results = [RunResult.from_json(raw[i]) for i in sorted(raw)]
        failure_rows = [rec for i in sorted(failures)
                        for rec in failures[i]]

    return package_dist_result(
        problem, budget, cfg, results, failure_rows, dist_info,
        [s.budget.seed for s in shards], time.perf_counter() - t0,
        device=dev)


def package_dist_result(problem: NocProblem, budget: Budget, cfg,
                        results: list[RunResult], failure_rows: list[dict],
                        dist_info: dict, worker_seeds: list[int],
                        wall_s: float, *, partial: bool = False,
                        device=None) -> RunResult:
    """Merge surviving worker results into the final ``"stage_dist"``
    :class:`RunResult` — the packaging tail shared by :func:`run_dist`
    and the request state machines of :mod:`repro_torch.noc.server`.

    With more than one surviving result, the merged front's PHV is
    recomputed under the problem's own mesh anchor, evaluated on
    ``device`` (default ``"cuda"``).

    ``partial=True`` is the graceful-degradation path (deadline trip or
    cancellation): instead of raising when nothing survived, it returns
    the best-so-far front — possibly empty — flagged
    ``extra["partial"] = True`` and ``exhausted=True`` (the budget was
    truncated from outside, same contract as running it dry)."""
    import numpy as np

    if not results:
        if not partial:
            raise RuntimeError(
                f"all {cfg.n_workers} workers failed: {failure_rows}")
        merged = RunResult(
            optimizer="stage_dist", problem=problem.to_json(),
            budget=budget.to_json(), config=dataclasses.asdict(cfg),
            obj_idx=tuple(problem.obj_idx), designs=[],
            objs=np.zeros((0, len(problem.obj_idx))),
            n_evals=0, n_calls=0, wall_s=0.0, history=np.zeros((0, 4)),
            extra={"phv": 0.0}, exhausted=True)
    elif len(results) > 1:
        # The merged set's PHV is recomputed under the problem's own mesh
        # anchor — one coordinator-side evaluation, outside the (fully
        # worker-consumed) search budget.
        ctx = problem.context(problem.evaluator(device=device))
        merged = merge_results(results, ctx=ctx)
    else:
        merged = merge_results(results)   # identity passthrough (W=1 pin)

    extra = dict(merged.extra)
    extra["n_workers"] = int(cfg.n_workers)
    extra["executor"] = cfg.executor
    extra["sync_every"] = int(cfg.sync_every)
    extra["worker_seeds"] = list(worker_seeds)
    extra["worker_failures"] = failure_rows
    extra["pool_rebuilds"] = dist_info.get("pool_rebuilds", 0)
    extra["resumed_from_round"] = dist_info.get("resumed_from_round")
    extra["checkpoint"] = dist_info.get("checkpoint")
    exhausted = merged.exhausted
    if budget.max_evals is not None and merged.n_evals >= budget.max_evals:
        exhausted = True
    if budget.max_calls is not None and merged.n_calls >= budget.max_calls:
        exhausted = True
    if partial:
        extra["partial"] = True
        exhausted = True

    return dataclasses.replace(
        merged,
        optimizer="stage_dist",
        problem=problem.to_json(),
        budget=budget.to_json(),
        config=dataclasses.asdict(cfg),
        wall_s=wall_s,
        extra=extra,
        exhausted=exhausted,
    )
