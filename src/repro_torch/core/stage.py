"""Algorithm 2 — MOO-STAGE.

Iterates: Local search (Alg. 1, PHV-greedy) → merge into the global
non-dominated set → learn Eval : features(d) ↦ PHV(local_search(d)) from all
past trajectories (aggregated training set, DAgger-style) → Meta search
(greedy ascent on Eval from d_last) to choose the next restart; random
restart when the meta search cannot move (Alg. 2 lines 9-13).

The whole loop is array-shaped: feature extraction is batched
(:func:`repro_torch.core.features.design_features_batch`), the surrogate
scores a whole sampled neighborhood per meta step in one device pass
(:class:`repro_torch.core.fused.MetaScorer`), and :func:`stage_batch` runs K
restart chains in lockstep so every candidate evaluation in the expensive
phase goes through the evaluator's batched APSP/objective path in shared
device passes. The surrogate and the scorer run on the evaluator's
device."""

from __future__ import annotations

import dataclasses

import numpy as np

from .evaluate import Evaluator
from .features import design_features_batch
from .forest import RegressionForest
from .fused import MetaScorer, check_meta_backend
from .local_search import (LocalResult, ParetoSet, SearchHistory,
                           local_search, local_search_batch)
from .pareto import PhvContext
from .problem import (Design, SystemSpec, random_design,
                      sample_neighbor_moves, sample_neighbors)
from ..tracing import span


def _merge_forest_kwargs(forest_kwargs: dict | None,
                         forest_backend: str | None, device) -> dict:
    """Surrogate construction kwargs with the backend knob and the
    evaluator's device folded in; an explicit ``backend`` inside
    ``forest_kwargs`` wins over the knob."""
    fk = dict(forest_kwargs or {})
    if forest_backend is not None:
        fk.setdefault("backend", forest_backend)
    fk.setdefault("device", device)
    return fk


@dataclasses.dataclass
class StageResult:
    global_set: ParetoSet
    history: SearchHistory
    eval_errors: list[tuple[int, float]]   # (iteration, |Eval(d_start) - actual PHV|/PHV)
    n_local_searches: int
    converged: bool


@dataclasses.dataclass
class StageBatchResult:
    """Multi-start MOO-STAGE outcome: one global Pareto set merged across
    all K chains plus the usual diagnostics.

    ``x_train``/``y_train`` are the surrogate training rows collected by
    THIS call only (``train_init`` rows are not echoed back), and
    ``next_starts`` are the designs the driver would have restarted from
    next — together they are the checkpoint a distributed coordinator
    pools between sync rounds."""

    global_set: ParetoSet
    history: SearchHistory
    eval_errors: list[tuple[int, float]]
    n_local_searches: int
    n_starts: int
    n_evals: int
    converged: bool
    x_train: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0)))
    y_train: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,)))
    next_starts: list[Design] = dataclasses.field(default_factory=list)


def _meta_greedy_host(
    spec: SystemSpec,
    model: RegressionForest,
    d_from: Design,
    rng: np.random.Generator,
    *,
    n_swaps: int,
    n_link_moves: int,
    max_steps: int = 30,
) -> Design:
    """The legacy host-side meta step: materialize every candidate as a
    ``Design``, featurize the batch on the host, then one flat-forest
    ``predict``. Kept as the ``meta_backend="host"`` arm and the parity
    oracle for the fused path."""
    d_curr = d_from
    v_curr = float(model.predict(design_features_batch(spec, [d_curr]))[0])
    for _ in range(max_steps):
        cands = sample_neighbors(spec, d_curr, rng, n_swaps, n_link_moves)
        if not cands:
            break
        vals = model.predict(design_features_batch(spec, cands))
        j = int(np.argmax(vals))
        if vals[j] <= v_curr + 1e-12:
            break
        d_curr, v_curr = cands[j], float(vals[j])
    return d_curr


def _meta_greedy(
    spec: SystemSpec,
    model: RegressionForest,
    d_from: Design,
    rng: np.random.Generator,
    *,
    n_swaps: int,
    n_link_moves: int,
    max_steps: int = 30,
    backend: str = "fused",
    scorer: MetaScorer | None = None,
) -> Design:
    """Greedy ascent on the learned Eval (Alg. 2 line 9). Uses only cheap
    structural features — no objective evaluations are spent here.

    ``backend="fused"`` (default) runs each step as one device pass: the
    neighborhood stays in move form (problem.NeighborMoves), move-apply →
    featurize run as torch ops and normalize → forest traversal → argmax
    as kernel K3 (core.fused); only the winning move is materialized.
    ``"host"`` is the host-featurizing loop. Both arms consume the
    identical rng stream and accept with the same strict
    ``vals[j] > v_curr + 1e-12`` test.

    ``scorer`` reuses an already-built :class:`~repro_torch.core.fused.MetaScorer`
    for this model (the multi-chain driver scores every chain's restart
    against one fitted forest)."""
    check_meta_backend(backend)
    with span("noc.surrogate.meta"):
        if backend == "host":
            return _meta_greedy_host(
                spec, model, d_from, rng, n_swaps=n_swaps,
                n_link_moves=n_link_moves, max_steps=max_steps)
        sc = scorer if scorer is not None else MetaScorer(
            spec, model, backend=backend, device=model.device)
        d_curr = d_from
        v_curr = sc.score_base(d_curr)
        for _ in range(max_steps):
            moves = sample_neighbor_moves(spec, d_curr, rng, n_swaps,
                                          n_link_moves)
            if not len(moves):
                break
            j, vj = sc.score_moves(moves)
            if vj <= v_curr + 1e-12:
                break
            d_curr, v_curr = moves.materialize(j), vj
        return d_curr


def moo_stage(
    spec: SystemSpec,
    ev: Evaluator,
    ctx: PhvContext,
    d0: Design,
    seed: int = 0,
    *,
    iters_max: int = 12,
    n_swaps: int = 24,
    n_link_moves: int = 24,
    max_local_steps: int = 10_000,
    forest_kwargs: dict | None = None,
    forest_backend: str | None = None,
    meta_backend: str = "fused",
    history: SearchHistory | None = None,
    max_evals: int | None = None,
) -> StageResult:
    """Single-start MOO-STAGE. ``max_evals`` bounds the total objective
    evaluations (absolute w.r.t. ``ev.n_evals``, same accounting as
    :func:`stage_batch`); ``None`` keeps the legacy unbudgeted behavior.
    ``forest_backend`` selects the surrogate inference backend
    (core.forest.FOREST_BACKENDS; ``None`` keeps the forest's ``"auto"``);
    ``meta_backend`` selects the meta-search scoring path
    (core.fused.META_BACKENDS — see :func:`_meta_greedy`). The surrogate
    runs on ``ev.device``."""
    check_meta_backend(meta_backend)
    rng = np.random.default_rng(seed)
    history = history or SearchHistory(ev, ctx)
    s_global = ParetoSet.empty()
    x_train: list[np.ndarray] = []
    y_train: list[float] = []
    eval_errors: list[tuple[int, float]] = []
    model: RegressionForest | None = None
    d_start = d0
    converged = False
    n_local = 0

    for it in range(iters_max):
        if max_evals is not None and ev.n_evals >= max_evals:
            break
        predicted = (
            float(model.predict(design_features_batch(spec, [d_start]))[0])
            if model is not None
            else None
        )
        res: LocalResult = local_search(
            spec, ev, ctx, d_start, rng,
            n_swaps=n_swaps, n_link_moves=n_link_moves,
            max_steps=max_local_steps, history=history, max_evals=max_evals,
        )
        n_local += 1
        if predicted is not None and res.phv > 0:
            eval_errors.append((it, abs(predicted - res.phv) / res.phv))

        # Merge local set into global set (Alg. 2 lines 3-4).
        merged = s_global.merged_with(
            res.local.designs, res.local.objs, ctx.obj_idx
        )
        new_keys = merged.keys() - s_global.keys()
        local_keys = res.local.keys()
        s_global = merged
        if not (new_keys & local_keys):
            # Local search contributed nothing new — converged (lines 5-6).
            converged = True
            break

        # Aggregate training examples: every trajectory design is labeled
        # with the PHV its local search achieved (line 7).
        with span("noc.surrogate.fit"):
            x_train.extend(design_features_batch(spec, res.traj))
            y_train.extend([res.phv] * len(res.traj))

            fk = _merge_forest_kwargs(forest_kwargs, forest_backend,
                                      ev.device)
            model = RegressionForest(seed=seed + it, **fk).fit(
                np.stack(x_train), np.asarray(y_train)
            )

        d_restart = _meta_greedy(
            spec, model, res.d_last, rng,
            n_swaps=n_swaps, n_link_moves=n_link_moves,
            backend=meta_backend,
        )
        if d_restart.key() == res.d_last.key():
            d_start = random_design(spec, rng)          # lines 10-11
        else:
            d_start = d_restart                          # line 13

    return StageResult(
        global_set=s_global,
        history=history,
        eval_errors=eval_errors,
        n_local_searches=n_local,
        converged=converged,
    )


def stage_batch(
    spec: SystemSpec,
    f: np.ndarray,
    n_starts: int = 4,
    seed: int = 0,
    *,
    case: str = "case3",
    backend: str = "auto",
    device=None,
    delta: str = "auto",
    iters_max: int = 12,
    n_swaps: int = 24,
    n_link_moves: int = 24,
    max_local_steps: int = 10_000,
    forest_kwargs: dict | None = None,
    forest_backend: str | None = None,
    meta_backend: str = "fused",
    max_evals: int | None = None,
    ev: Evaluator | None = None,
    ctx: PhvContext | None = None,
    history: SearchHistory | None = None,
    d0: Design | None = None,
    starts: list[Design] | None = None,
    train_init: tuple[np.ndarray, np.ndarray] | None = None,
    global_init: ParetoSet | None = None,
    checkpoint_restarts: bool = False,
) -> StageBatchResult:
    """Multi-start MOO-STAGE: K restart chains advanced in lockstep.

    All chains share one evaluator (their per-step neighborhoods are
    concatenated into single batched APSP + objective dispatches via
    :func:`local_search_batch`), one global non-dominated set, and one
    aggregated Eval training set — every chain's trajectories teach the one
    surrogate, which then steers every chain's next restart (cross-chain
    DAgger). Chain 0 starts from ``d0`` (default: the 3D mesh, §6.3); chain
    i starts from the mesh perturbed by 2·i random neighbor moves — diverse
    basins without wasting budget on uniformly random (far-from-mesh)
    starting designs.

    ``max_evals`` bounds the total objective-evaluation budget across all
    chains (checked per lockstep step), making equal-budget comparisons
    against the single-start driver direct. ``delta`` is Evaluator's
    incremental-move-evaluation mode (``"auto"`` enables host table deltas
    at DELTA_AUTO_MIN_TILES+ tiles, e.g. spec_large; the paper specs keep
    the dense batched path). ``device`` is where a new evaluator runs
    (default ``"cuda"``). ``forest_backend`` selects the
    shared surrogate's inference backend (core.forest.FOREST_BACKENDS;
    ``None`` keeps the forest's ``"auto"``).

    ``starts`` overrides the mesh-perturbation start construction with
    explicit per-chain designs (len must equal ``n_starts``);
    ``train_init`` is an ``(X, y)`` pair of surrogate training rows fitted
    into a model *before* the first iteration; ``global_init`` seeds the
    global non-dominated set (its designs cost no evaluations — their
    objective rows ride along), so chains greedily maximize *marginal*
    PHV over what other workers already found. Together they let a
    round-based coordinator resume K chains with a pooled cross-worker
    surrogate and front. ``checkpoint_restarts``
    additionally refits the surrogate on convergence (an eval-free meta
    search) so ``next_starts`` holds genuine restart designs instead of
    the already-locally-optimal ``d_last``s. All default to
    None/False, leaving the single-call behavior (and its
    seeded-determinism pin) unchanged.
    """
    from .objectives import CASES

    if n_starts < 1:
        raise ValueError(f"n_starts must be >= 1, got {n_starts}")
    check_meta_backend(meta_backend)
    rng = np.random.default_rng(seed)
    if ev is None:
        ev = Evaluator(spec, f, backend=backend, device=device, delta=delta)
    if ctx is None:
        ctx = PhvContext(ev(spec.mesh_design()), CASES[case])
    history = history or SearchHistory(ev, ctx)

    if starts is None:
        base = d0 or spec.mesh_design()
        starts = [base]
        for i in range(1, n_starts):
            d = base
            for _ in range(2 * i):  # chain i: 2·i random moves away from base
                nb = sample_neighbors(spec, d, rng, 1, 1)
                if nb:
                    d = nb[int(rng.integers(len(nb)))]
            starts.append(d)
    else:
        if len(starts) != n_starts:
            raise ValueError(
                f"explicit starts must have n_starts={n_starts} designs, "
                f"got {len(starts)}")
        starts = list(starts)

    s_global = global_init if global_init is not None else ParetoSet.empty()
    x_train: list[np.ndarray] = []
    y_train: list[float] = []
    eval_errors: list[tuple[int, float]] = []
    fk = _merge_forest_kwargs(forest_kwargs, forest_backend, ev.device)
    x_init = y_init = None
    model: RegressionForest | None = None
    if train_init is not None:
        x_init = np.asarray(train_init[0], dtype=np.float64)
        y_init = np.asarray(train_init[1], dtype=np.float64)
        if x_init.shape[0] != y_init.shape[0]:
            raise ValueError("train_init X and y row counts differ")
        if x_init.shape[0]:
            # Warm surrogate: seeded past the per-iteration range (it <
            # iters_max) so the entry fit never collides with a refit seed.
            with span("noc.surrogate.fit"):
                model = RegressionForest(seed=seed + iters_max, **fk).fit(
                    x_init, y_init)
    converged = False
    n_local = 0
    next_starts = list(starts)

    for it in range(iters_max):
        if max_evals is not None and ev.n_evals >= max_evals:
            break
        predicted = (
            model.predict(design_features_batch(spec, starts))
            if model is not None
            else None
        )
        results = local_search_batch(
            spec, ev, ctx, starts, rng,
            n_swaps=n_swaps, n_link_moves=n_link_moves,
            max_steps=max_local_steps, history=history, max_evals=max_evals,
            seed_set=s_global if s_global.designs else None,
        )
        n_local += len(results)
        next_starts = [res.d_last for res in results]

        any_new = False
        for ci, res in enumerate(results):
            if predicted is not None and res.phv > 0:
                eval_errors.append((it, abs(float(predicted[ci]) - res.phv) / res.phv))
            merged = s_global.merged_with(
                res.local.designs, res.local.objs, ctx.obj_idx)
            if merged.keys() - s_global.keys():  # new keys can only be local
                any_new = True
            s_global = merged
            with span("noc.surrogate.fit"):
                x_train.extend(design_features_batch(spec, res.traj))
                y_train.extend([res.phv] * len(res.traj))

        def _refit_and_restart():
            with span("noc.surrogate.fit"):
                xs = np.stack(x_train)
                ys = np.asarray(y_train, dtype=np.float64)
                if x_init is not None and x_init.shape[0]:
                    xs = np.vstack([x_init, xs])
                    ys = np.concatenate([y_init, ys])
                m = RegressionForest(seed=seed + it, **fk).fit(xs, ys)
            # One scorer per refit, shared by every chain's meta search
            # (device-resident forest tensors transfer once, not K times).
            with span("noc.surrogate.meta"):
                sc = (MetaScorer(spec, m, backend=meta_backend,
                                 device=ev.device)
                      if meta_backend != "host" else None)
            new_starts = []
            for res in results:
                d_restart = _meta_greedy(
                    spec, m, res.d_last, rng,
                    n_swaps=n_swaps, n_link_moves=n_link_moves,
                    backend=meta_backend, scorer=sc,
                )
                if d_restart.key() == res.d_last.key():
                    new_starts.append(random_design(spec, rng))  # lines 10-11
                else:
                    new_starts.append(d_restart)                  # line 13
            return m, new_starts

        if not any_new:
            converged = True
            if checkpoint_restarts:
                # The meta search costs no objective evaluations — still
                # pick the restarts a continuing run would use, so a
                # resuming coordinator round doesn't
                # relaunch chains at their already-locally-optimal d_last
                # and instantly re-converge on budget it could have spent
                # exploring. Opt-in: callers that never read next_starts
                # (the registry driver, the benchmarks) skip the refit.
                _, next_starts = _refit_and_restart()
            break
        if max_evals is not None and ev.n_evals >= max_evals:
            break

        model, starts = _refit_and_restart()
        next_starts = list(starts)

    return StageBatchResult(
        global_set=s_global,
        history=history,
        eval_errors=eval_errors,
        n_local_searches=n_local,
        n_starts=n_starts,
        n_evals=ev.n_evals,
        converged=converged,
        x_train=(np.stack(x_train) if x_train else np.zeros((0, 0))),
        y_train=np.asarray(y_train, dtype=np.float64),
        next_starts=next_starts,
    )
