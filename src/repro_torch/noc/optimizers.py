"""Optimizer registry: the search drivers of the port behind one protocol.

Each entry pairs a string name with a per-optimizer config dataclass and an
adapter that invokes the underlying driver. The entries here — ``stage``,
``stage_batch``, ``local``, the baselines ``amosa``, ``nsga2`` and
``pcbb``, and the distributed coordinator ``stage_dist`` — call their
drivers with the reference registry's argument set, so a run at a given
:class:`~repro_torch.noc.api.Budget` consumes the same rng streams and
evaluation accounting as the reference.

Adapters return ``(ParetoSet, extra)``; :func:`repro_torch.noc.api.run`
wraps them with the budget guard and packages the :class:`RunResult`. An
entry registered with ``owns_result=True`` (``stage_dist``) is called as
``run_fn(problem, budget, cfg, device)`` instead and returns the complete
:class:`RunResult`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from ..core.amosa import amosa
from ..core.forest import check_forest_backend
from ..core.fused import check_meta_backend
from ..core.local_search import ParetoSet, local_search_batch
from ..core.nsga2 import nsga2
from ..core.pcbb import pcbb
from ..core.problem import random_design
from ..core.stage import moo_stage, stage_batch

from .api import Budget, NocProblem, RunResult


# --------------------------------------------------------------------------
# Per-optimizer configs
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StageConfig:
    """MOO-STAGE (Alg. 2) knobs — see :func:`repro_torch.core.stage.moo_stage`.

    ``forest_backend`` overrides the problem's surrogate inference backend
    (``None`` inherits ``NocProblem.forest_backend``); ``meta_backend``
    selects the meta-search scoring path (core.fused.META_BACKENDS —
    ``"fused"`` is the one-pass-per-step device pipeline ending in kernel
    K3, ``"host"`` the host-featurizing loop)."""

    iters_max: int = 12
    n_swaps: int = 24
    n_link_moves: int = 24
    max_local_steps: int = 10_000
    forest_kwargs: dict | None = None
    forest_backend: str | None = None
    meta_backend: str = "fused"

    def __post_init__(self):
        # Fail at config construction, not at the first surrogate refit
        # after the initial evaluation budget has already been spent.
        check_forest_backend(self.forest_backend, allow_none=True)
        check_meta_backend(self.meta_backend)


@dataclasses.dataclass(frozen=True)
class StageBatchConfig:
    """Multi-start MOO-STAGE — see :func:`repro_torch.core.stage.stage_batch`.

    ``forest_backend`` overrides the problem's surrogate inference backend
    (``None`` inherits ``NocProblem.forest_backend``); ``meta_backend``
    selects the meta-search scoring path (core.fused.META_BACKENDS)."""

    n_starts: int = 4
    iters_max: int = 12
    n_swaps: int = 24
    n_link_moves: int = 24
    max_local_steps: int = 10_000
    forest_kwargs: dict | None = None
    forest_backend: str | None = None
    meta_backend: str = "fused"

    def __post_init__(self):
        check_forest_backend(self.forest_backend, allow_none=True)
        check_meta_backend(self.meta_backend)


@dataclasses.dataclass(frozen=True)
class StageDistConfig:
    """Distributed multi-start MOO-STAGE — see
    :func:`repro_torch.dist.run_dist`.

    ``n_workers`` shards the global budget (remainder-exact; per-worker
    seeds spawned from the root seed); ``executor`` picks where shards
    run (``"serial"`` in-process, ``"process"`` spawn-based
    ``ProcessPoolExecutor``, ``"cuda"`` one shard per CUDA device in one
    thread, ``"spmd"`` in-order shards whose evaluator splits every batch
    across the visible CUDA devices — repro_torch.dist.worker);
    ``sync_every`` > 0 pools surrogate training rows across workers every
    that many STAGE iterations (0 = fully independent workers). The
    remaining knobs configure each worker's ``stage_batch`` run
    (``n_starts`` chains *per worker*, default 1 — W workers × 1 chain is
    the like-for-like peer of ``stage_batch(n_starts=W)``).

    Resilience knobs: ``shard_timeout_s`` is the per-shard wall-clock
    deadline (preemptive under ``process``, cooperative in-process);
    ``max_retries`` / ``retry_backoff_s`` bound the reseeded re-dispatches
    of a failed shard; ``checkpoint_dir`` persists coordinator state after
    every sync round (atomic writes) and ``resume=True`` restores the
    latest round from it; ``faults`` is a deterministic fault script (see
    :mod:`repro_torch.dist.faults`) for tests and chaos drills. All knobs
    are validated here, at construction — not mid-run after budget has
    been spent. The device is not a knob: it is :func:`repro_torch.noc.run`'s
    argument."""

    n_workers: int = 4
    executor: str = "serial"
    sync_every: int = 0
    n_starts: int = 1
    iters_max: int = 12
    n_swaps: int = 24
    n_link_moves: int = 24
    max_local_steps: int = 10_000
    forest_kwargs: dict | None = None
    forest_backend: str | None = None
    meta_backend: str = "fused"
    shard_timeout_s: float | None = None
    max_retries: int = 1
    retry_backoff_s: float = 0.0
    checkpoint_dir: str | None = None
    resume: bool = False
    faults: tuple = ()

    def __post_init__(self):
        from ..dist.faults import check_faults
        from ..dist.worker import check_executor

        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        if self.sync_every < 0:
            raise ValueError(
                f"sync_every must be >= 0, got {self.sync_every}")
        check_executor(self.executor)
        check_forest_backend(self.forest_backend, allow_none=True)
        check_meta_backend(self.meta_backend)
        if self.shard_timeout_s is not None and self.shard_timeout_s <= 0:
            raise ValueError(f"shard_timeout_s must be > 0 or None, "
                             f"got {self.shard_timeout_s}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {self.retry_backoff_s}")
        if self.resume and not self.checkpoint_dir:
            raise ValueError("resume=True requires checkpoint_dir")
        if self.checkpoint_dir and self.sync_every < 1:
            raise ValueError(
                "checkpoint_dir requires sync_every >= 1 — round "
                "checkpoints exist at sync-round boundaries only")
        object.__setattr__(self, "faults", tuple(self.faults or ()))
        check_faults(self.faults)


@dataclasses.dataclass(frozen=True)
class AmosaConfig:
    """AMOSA baseline — see :func:`repro_torch.core.amosa.amosa`."""

    t_max: float = 1.0
    t_min: float = 1e-4
    alpha: float = 0.92
    iters_per_temp: int = 40
    soft_limit: int = 40
    hard_limit: int = 24
    block_size: int = 1
    adaptive_block: bool = False
    block_max: int = 16


@dataclasses.dataclass(frozen=True)
class Nsga2Config:
    """NSGA-II baseline — see :func:`repro_torch.core.nsga2.nsga2`.
    ``rank_backend`` ``"auto"`` scores selection on the evaluator's device
    when it is a CUDA device, in numpy on the CPU."""

    pop_size: int = 32
    generations: int = 30
    p_mutate: float = 0.6
    rank_backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class LocalConfig:
    """PHV-greedy local search (Alg. 1); ``n_starts`` > 1 runs lockstep
    chains (chain 0 from the mesh, the rest from random designs)."""

    n_starts: int = 1
    n_swaps: int = 24
    n_link_moves: int = 24
    max_steps: int = 10_000
    max_set: int = 24


@dataclasses.dataclass(frozen=True)
class PcbbConfig:
    """PCBB branch-and-bound baseline — see :func:`repro_torch.core.pcbb.pcbb`.

    PCBB has no native ``max_evals``; the budget guard enforces it."""

    compensation: float = 0.15
    n_random_rollouts: int = 2
    link_descent_steps: int = 10
    max_expansions: int = 200_000


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class OptimizerEntry:
    name: str
    config_cls: type
    run_fn: Callable[..., tuple[ParetoSet, dict]]
    #: the driver enforces Budget.max_evals itself (stops at the guard's
    #: exact threshold) — lets run() skip the fallback-Pareto upkeep.
    native_max_evals: bool = True
    #: the adapter returns a complete RunResult instead of (ParetoSet,
    #: extra) — for coordinators (e.g. "stage_dist") whose evaluations
    #: happen on evaluators run() cannot see (other processes/devices), so
    #: the driver must own accounting, history, and budget enforcement.
    owns_result: bool = False


OPTIMIZERS: dict[str, OptimizerEntry] = {}


def register(name: str, config_cls: type, *, native_max_evals: bool = True,
             owns_result: bool = False):
    """Decorator: add an adapter to the registry under ``name``."""

    def deco(fn):
        if name in OPTIMIZERS:
            raise ValueError(f"optimizer {name!r} already registered")
        OPTIMIZERS[name] = OptimizerEntry(name, config_cls, fn,
                                          native_max_evals, owns_result)
        return fn

    return deco


def optimizer_names() -> tuple[str, ...]:
    return tuple(sorted(OPTIMIZERS))


def get_optimizer(name: str) -> OptimizerEntry:
    if name not in OPTIMIZERS:
        raise ValueError(
            f"unknown optimizer {name!r}; registered: {optimizer_names()}")
    return OPTIMIZERS[name]


def make_config(entry: OptimizerEntry, config: Any):
    """Coerce None / dict-of-overrides / dataclass into the entry's config."""
    if config is None:
        return entry.config_cls()
    if isinstance(config, dict):
        return entry.config_cls(**config)
    if isinstance(config, entry.config_cls):
        return config
    raise TypeError(
        f"config for {entry.name!r} must be None, dict, or "
        f"{entry.config_cls.__name__}, got {type(config).__name__}")


# --------------------------------------------------------------------------
# Adapters
# --------------------------------------------------------------------------
@register("stage", StageConfig)
def _run_stage(problem: NocProblem, budget: Budget, cfg: StageConfig,
               ev, ctx, history) -> tuple[ParetoSet, dict]:
    res = moo_stage(
        problem.spec, ev, ctx, problem.mesh(), seed=budget.seed,
        iters_max=cfg.iters_max, n_swaps=cfg.n_swaps,
        n_link_moves=cfg.n_link_moves, max_local_steps=cfg.max_local_steps,
        forest_kwargs=cfg.forest_kwargs,
        forest_backend=(cfg.forest_backend if cfg.forest_backend is not None
                        else problem.forest_backend),
        meta_backend=cfg.meta_backend,
        history=history, max_evals=budget.max_evals,
    )
    return res.global_set, {
        "converged": res.converged,
        "n_local_searches": res.n_local_searches,
        "eval_errors": [[it, float(e)] for it, e in res.eval_errors],
    }


@register("stage_batch", StageBatchConfig)
def _run_stage_batch(problem: NocProblem, budget: Budget,
                     cfg: StageBatchConfig, ev, ctx, history
                     ) -> tuple[ParetoSet, dict]:
    res = stage_batch(
        problem.spec, problem.traffic_matrix(), n_starts=cfg.n_starts,
        seed=budget.seed, case=problem.case, iters_max=cfg.iters_max,
        n_swaps=cfg.n_swaps, n_link_moves=cfg.n_link_moves,
        max_local_steps=cfg.max_local_steps, forest_kwargs=cfg.forest_kwargs,
        forest_backend=(cfg.forest_backend if cfg.forest_backend is not None
                        else problem.forest_backend),
        meta_backend=cfg.meta_backend,
        max_evals=budget.max_evals, ev=ev, ctx=ctx, history=history,
    )
    return res.global_set, {
        "converged": res.converged,
        "n_local_searches": res.n_local_searches,
        "n_starts": res.n_starts,
        "eval_errors": [[it, float(e)] for it, e in res.eval_errors],
    }


@register("amosa", AmosaConfig)
def _run_amosa(problem: NocProblem, budget: Budget, cfg: AmosaConfig,
               ev, ctx, history) -> tuple[ParetoSet, dict]:
    archive = amosa(
        problem.spec, ev, ctx, problem.mesh(), seed=budget.seed,
        t_max=cfg.t_max, t_min=cfg.t_min, alpha=cfg.alpha,
        iters_per_temp=cfg.iters_per_temp, soft_limit=cfg.soft_limit,
        hard_limit=cfg.hard_limit, max_evals=budget.max_evals,
        history=history, block_size=cfg.block_size,
        adaptive_block=cfg.adaptive_block, block_max=cfg.block_max,
    )
    return archive, {}


@register("nsga2", Nsga2Config)
def _run_nsga2(problem: NocProblem, budget: Budget, cfg: Nsga2Config,
               ev, ctx, history) -> tuple[ParetoSet, dict]:
    ps = nsga2(
        problem.spec, ev, ctx, problem.mesh(), seed=budget.seed,
        pop_size=cfg.pop_size, generations=cfg.generations,
        p_mutate=cfg.p_mutate, max_evals=budget.max_evals, history=history,
        rank_backend=cfg.rank_backend,
    )
    return ps, {}


@register("local", LocalConfig)
def _run_local(problem: NocProblem, budget: Budget, cfg: LocalConfig,
               ev, ctx, history) -> tuple[ParetoSet, dict]:
    rng = np.random.default_rng(budget.seed)
    starts = [problem.mesh()]
    for _ in range(1, cfg.n_starts):
        starts.append(random_design(problem.spec, rng))
    results = local_search_batch(
        problem.spec, ev, ctx, starts, rng, n_swaps=cfg.n_swaps,
        n_link_moves=cfg.n_link_moves, max_steps=cfg.max_steps,
        max_set=cfg.max_set, history=history, max_evals=budget.max_evals,
    )
    merged = ParetoSet.empty()
    for res in results:
        merged = merged.merged_with(res.local.designs, res.local.objs,
                                    ctx.obj_idx)
    return merged, {
        "phv_per_chain": [float(r.phv) for r in results],
        "n_steps_per_chain": [int(r.n_steps) for r in results],
    }


@register("pcbb", PcbbConfig, native_max_evals=False)
def _run_pcbb(problem: NocProblem, budget: Budget, cfg: PcbbConfig,
              ev, ctx, history) -> tuple[ParetoSet, dict]:
    res = pcbb(
        problem.spec, ev, ctx, seed=budget.seed,
        compensation=cfg.compensation,
        n_random_rollouts=cfg.n_random_rollouts,
        link_descent_steps=cfg.link_descent_steps,
        max_expansions=cfg.max_expansions, history=history,
    )
    return res.pareto, {
        "nodes_expanded": res.nodes_expanded,
        "nodes_pruned": res.nodes_pruned,
        "best_scalarized_objs": np.asarray(res.best_objs,
                                           dtype=np.float64).tolist(),
    }


@register("stage_dist", StageDistConfig, owns_result=True)
def _run_stage_dist(problem: NocProblem, budget: Budget,
                    cfg: StageDistConfig, device) -> RunResult:
    # Lazy import: repro_torch.dist imports repro_torch.noc.api at module
    # scope; a top-level import here would re-enter repro_torch.dist
    # mid-initialization whenever repro_torch.dist is imported first.
    from ..dist import run_dist

    return run_dist(problem, budget, cfg, device)
