"""Optimizer registry: the search drivers of the port behind one protocol.

Each entry pairs a string name with a per-optimizer config dataclass and an
adapter that invokes the underlying driver. The three entries here —
``stage``, ``stage_batch`` and ``local`` — call their drivers with the
reference registry's argument set, so a run at a given
:class:`~repro_torch.noc.api.Budget` consumes the same rng streams and
evaluation accounting as the reference.

Adapters return ``(ParetoSet, extra)``; :func:`repro_torch.noc.api.run`
wraps them with the budget guard and packages the :class:`RunResult`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from ..core.forest import check_forest_backend
from ..core.fused import check_meta_backend
from ..core.local_search import ParetoSet, local_search_batch
from ..core.problem import random_design
from ..core.stage import moo_stage, stage_batch

from .api import Budget, NocProblem


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
class LocalConfig:
    """PHV-greedy local search (Alg. 1); ``n_starts`` > 1 runs lockstep
    chains (chain 0 from the mesh, the rest from random designs)."""

    n_starts: int = 1
    n_swaps: int = 24
    n_link_moves: int = 24
    max_steps: int = 10_000
    max_set: int = 24


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class OptimizerEntry:
    name: str
    config_cls: type
    run_fn: Callable[..., tuple[ParetoSet, dict]]


OPTIMIZERS: dict[str, OptimizerEntry] = {}


def register(name: str, config_cls: type):
    """Decorator: add an adapter to the registry under ``name``."""

    def deco(fn):
        if name in OPTIMIZERS:
            raise ValueError(f"optimizer {name!r} already registered")
        OPTIMIZERS[name] = OptimizerEntry(name, config_cls, fn)
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
