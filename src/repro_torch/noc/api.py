"""Unified NoC-optimization API: problem / budget / result.

One serializable boundary for the optimizers of the port:

  * :class:`NocProblem` — spec + traffic + objective case + routing and
    surrogate knobs. The device is not part of the problem (nor of its JSON).
  * :class:`Budget` — evaluation / device-pass budget + seed, enforced
    uniformly (the :class:`BudgetedEvaluator` guard backstops drivers
    without native budget support, e.g. PCBB).
  * :class:`RunResult` — Pareto designs + full objective rows, the
    convergence history, eval/call accounting, and optimizer diagnostics;
    JSON ``save``/``load`` round-trips bit-exactly, and the JSON is the
    reference package's (``repro.noc.RunResult``) format.
  * :func:`run` — the one entry point: resolve an optimizer by registry
    name (see :mod:`repro_torch.noc.optimizers`), enforce the budget, record
    the run on ``device`` (default ``"cuda"``), return a :class:`RunResult`.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable

import numpy as np

from ..core.evaluate import Evaluator
from ..core.forest import check_forest_backend
from ..core.local_search import ParetoSet, SearchHistory
from ..core.objectives import CASES, N_OBJ
from ..core.pareto import PhvContext
from ..core.problem import (Design, SystemSpec, spec_16, spec_36, spec_64,
                            spec_tiny)
from ..core.routing import resolve_backend
from ..core.traffic import (APPLICATIONS, TrafficValidationError,
                            avg_traffic, traffic_matrix)

SPEC_NAMES = ("tiny", "16", "36", "64")


def named_spec(name: str) -> SystemSpec:
    """Resolve one of the paper's systems by short name ("tiny"/"16"/"36"/"64")."""
    specs = {"tiny": spec_tiny, "16": spec_16, "36": spec_36, "64": spec_64}
    if name not in specs:
        raise ValueError(f"unknown spec {name!r}; choose from {SPEC_NAMES}")
    return specs[name]()


# --------------------------------------------------------------------------
# Problem
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class NocProblem:
    """One NoC design problem: what is optimized, on which traffic.

    ``traffic`` is one of:
      * an application name (see ``core.traffic.APP_NAMES``),
      * a sequence of application names — their aggregated (AVG) traffic,
        the leave-one-out construction of the agnostic study (§6.4),
      * a model scenario ``{"model": arch, "phase": phase, "mesh": [d, m]}``
        — traffic derived from a real model config by
        ``repro_torch.workloads`` (``phase`` defaults to "train.fwd",
        ``mesh`` to the `derive_mesh` default, and both are resolved at
        construction so every spelling of a scenario hashes identically), or
      * an explicit (N, N) flit-rate matrix.

    Every variant is validated at construction (unknown app/model/phase
    names, non-tiling meshes, and non-finite / negative / zero-sum / wrongly
    shaped matrices raise ``TrafficValidationError``).

    ``case`` selects the objective subset (``core.objectives.CASES``);
    ``backend`` is the routing knob, which accepts only ``"auto"`` here;
    ``forest_backend`` selects the surrogate inference backend
    (core.forest.FOREST_BACKENDS).

    Equality/hashing go through the canonical JSON form (the generated
    dataclass ``__eq__`` would crash on ndarray traffic), so problems can
    key caches and dedup sets in a distributed fan-out.
    """

    spec: SystemSpec
    traffic: Any = "BFS"
    case: str = "case3"
    backend: str = "auto"
    forest_backend: str = "auto"

    def __post_init__(self):
        if self.case not in CASES:
            raise ValueError(
                f"unknown case {self.case!r}; choose from {tuple(CASES)}")
        resolve_backend(self.backend)
        check_forest_backend(self.forest_backend)
        object.__setattr__(self, "traffic", self._validate_traffic())

    def _validate_traffic(self):
        """Validate + canonicalize ``traffic``; raises TrafficValidationError."""
        t = self.traffic
        if isinstance(t, dict):
            # deferred: the workload layer pulls in the model-config registry
            from ..workloads import normalize_model_traffic

            return normalize_model_traffic(self.spec, t)
        if isinstance(t, str):
            if t not in APPLICATIONS:
                raise TrafficValidationError(
                    f"unknown application {t!r}; known: "
                    f"{', '.join(APPLICATIONS)}")
            return t
        if isinstance(t, (list, tuple)) and t and isinstance(t[0], str):
            unknown = [a for a in t if a not in APPLICATIONS]
            if unknown:
                raise TrafficValidationError(
                    f"unknown applications {unknown}; known: "
                    f"{', '.join(APPLICATIONS)}")
            return tuple(t)
        try:
            arr = np.asarray(t, dtype=np.float64)
        except (TypeError, ValueError) as e:
            raise TrafficValidationError(
                f"traffic matrix is not numeric: {e}") from e
        n = self.spec.n_tiles
        if arr.shape != (n, n):
            raise TrafficValidationError(
                f"traffic matrix shape {arr.shape} != ({n}, {n}) for this "
                "spec")
        if not np.all(np.isfinite(arr)):
            raise TrafficValidationError(
                "traffic matrix has non-finite entries")
        if np.any(arr < 0):
            raise TrafficValidationError(
                "traffic matrix has negative entries")
        if arr.sum() <= 0:
            raise TrafficValidationError("traffic matrix sums to zero")
        return arr

    def _canonical(self) -> str:
        # Cached: the dataclass is frozen, and re-serializing a 64-tile
        # traffic matrix per dict lookup would make problem keys expensive.
        c = self.__dict__.get("_canon")
        if c is None:
            c = json.dumps(self.to_json(), sort_keys=True)
            object.__setattr__(self, "_canon", c)
        return c

    def __eq__(self, other) -> bool:
        if not isinstance(other, NocProblem):
            return NotImplemented
        return self._canonical() == other._canonical()

    def __hash__(self) -> int:
        return hash(self._canonical())

    # ------------------------------------------------------------ builders
    def traffic_matrix(self) -> np.ndarray:
        t = self.traffic
        if isinstance(t, dict):
            from ..workloads import scenario_matrix

            return scenario_matrix(self.spec, t["model"], t["phase"],
                                   mesh=t["mesh"])
        if isinstance(t, str):
            return traffic_matrix(self.spec, t)
        if isinstance(t, (list, tuple)) and t and isinstance(t[0], str):
            return avg_traffic(self.spec, list(t))
        return np.asarray(t, dtype=np.float64)

    def evaluator(self, device=None, **kwargs) -> Evaluator:
        """An evaluator for this problem on ``device`` (default ``"cuda"``;
        raises when no card is present)."""
        return Evaluator(self.spec, self.traffic_matrix(),
                         backend=self.backend, device=device, **kwargs)

    def mesh(self) -> Design:
        return self.spec.mesh_design()

    def context(self, ev: Evaluator, *,
                phv_backend: str = "host") -> PhvContext:
        """PHV context normalized by the mesh design (costs one
        evaluation).

        ``phv_backend`` is a context knob (not a problem field — problems
        hash by canonical JSON): ``"device"`` opts the batched chain-step
        scorer into the f32 twin on the evaluator's device (see
        :class:`PhvContext`)."""
        return PhvContext(ev(self.mesh()), CASES[self.case],
                          phv_backend=phv_backend,
                          device=ev.device if phv_backend == "device"
                          else None)

    @property
    def obj_idx(self) -> tuple[int, ...]:
        return CASES[self.case]

    # --------------------------------------------------------------- (de)ser
    def to_json(self) -> dict:
        t = self.traffic
        if isinstance(t, str):
            traffic: Any = {"app": t}
        elif isinstance(t, (list, tuple)) and t and isinstance(t[0], str):
            traffic = {"avg": list(t)}
        elif isinstance(t, dict):
            traffic = {"model": t["model"], "phase": t["phase"],
                       "mesh": list(t["mesh"])}
        else:
            traffic = {"matrix": np.asarray(t, dtype=np.float64).tolist()}
        return {"spec": dataclasses.asdict(self.spec), "traffic": traffic,
                "case": self.case, "backend": self.backend,
                "forest_backend": self.forest_backend}

    @staticmethod
    def from_json(obj: dict) -> "NocProblem":
        t = obj["traffic"]
        if "app" in t:
            traffic: Any = t["app"]
        elif "model" in t:
            traffic = {k: t[k] for k in ("model", "phase", "mesh") if k in t}
        elif "avg" in t:
            traffic = tuple(t["avg"])
        else:
            traffic = np.asarray(t["matrix"], dtype=np.float64)
        return NocProblem(spec=SystemSpec(**obj["spec"]), traffic=traffic,
                          case=obj["case"], backend=obj.get("backend", "auto"),
                          forest_backend=obj.get("forest_backend", "auto"))


# --------------------------------------------------------------------------
# Budget
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Budget:
    """Uniform search budget: objective evaluations, device passes, seed.

    ``max_evals``/``max_calls`` are absolute with respect to the
    evaluator's ``n_evals``/``n_calls`` counters — the exact accounting the
    drivers use, which makes registry runs and direct driver calls agree at
    equal budgets. :func:`run` creates a fresh evaluator by default, so the
    budget covers the whole run including the mesh evaluation that anchors
    the PHV context; pass a fresh ``ev=`` if you override it.
    """

    max_evals: int | None = None
    max_calls: int | None = None
    seed: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(obj: dict) -> "Budget":
        return Budget(**obj)


class BudgetExhausted(RuntimeError):
    """Raised by :class:`BudgetedEvaluator` when a dispatch would start past
    the budget. :func:`run` catches it and returns the best-so-far result."""


class BudgetedEvaluator:
    """Evaluator proxy enforcing a :class:`Budget` before every dispatch.

    Drivers with native ``max_evals`` checks stop themselves at exactly the
    same threshold, so for them the guard can only fire on their very first
    dispatch (issued before their own loop-top check) — i.e. only when the
    budget was already spent at entry, where an empty result is accurate —
    and never alters the driver's own run. It backstops drivers without
    native budget support (e.g. PCBB) and enforces ``max_calls`` uniformly.
    """

    def __init__(self, ev: Evaluator, budget: Budget):
        self._ev = ev
        self._budget = budget

    def _check(self) -> None:
        b = self._budget
        if b.max_evals is not None and self._ev.n_evals >= b.max_evals:
            raise BudgetExhausted(
                f"evaluation budget exhausted ({self._ev.n_evals}/"
                f"{b.max_evals} evals)")
        if b.max_calls is not None and self._ev.n_calls >= b.max_calls:
            raise BudgetExhausted(
                f"dispatch budget exhausted ({self._ev.n_calls}/"
                f"{b.max_calls} calls)")

    # Mirror the Evaluator surface; everything funnels through batch_aux.
    def batch_aux(self, designs: list[Design]):
        if designs:
            self._check()
        return self._ev.batch_aux(designs)

    def batch(self, designs: list[Design]) -> np.ndarray:
        return self.batch_aux(designs)[0]

    def batch_moves(self, moves) -> np.ndarray:
        # Must be mirrored here, not left to __getattr__: the raw
        # evaluator's batch_moves dispatches internally (its delta path
        # never calls back through this proxy's batch), so delegation
        # would silently skip the budget check.
        ms = moves if isinstance(moves, (list, tuple)) else [moves]
        if any(len(m) for m in ms):
            self._check()
        return self._ev.batch_moves(moves)

    def __call__(self, d: Design) -> np.ndarray:
        return self.batch([d])[0]

    def edp(self, d: Design) -> float:
        self._check()
        return self._ev.edp(d)

    def __getattr__(self, name: str):
        return getattr(self._ev, name)


# --------------------------------------------------------------------------
# Recording
# --------------------------------------------------------------------------
class RunRecorder(SearchHistory):
    """SearchHistory that also keeps the Pareto set of recorded designs
    (fallback result when the budget guard fires mid-driver) and streams an
    optional per-record telemetry callback.

    ``keep_pareto`` gates the per-record Pareto merge: an unbudgeted run
    can never hit the guard, so it skips the upkeep entirely (the merge is
    a pareto_mask over the accumulated set per recorded evaluation)."""

    def __init__(self, ev, ctx: PhvContext,
                 callback: Callable[[dict], None] | None = None,
                 track_phv: bool = False, keep_pareto: bool = True):
        super().__init__(ev, ctx, track_phv=track_phv)
        self.pareto = ParetoSet.empty()
        self.callback = callback
        self.keep_pareto = keep_pareto

    def record(self, ev, d: Design, objs: np.ndarray):
        super().record(ev, d, objs)
        if self.keep_pareto:
            self.pareto = self.pareto.merged_with(
                [d], np.asarray(objs, dtype=np.float64)[None],
                self.ctx.obj_idx)
        if self.callback is not None:
            wall, n_evals, best_edp, phv = self.rows[-1]
            self.callback({"n_evals": int(n_evals), "n_calls": int(ev.n_calls),
                           "best_edp": float(best_edp), "wall_s": float(wall),
                           "phv": float(phv)})


# --------------------------------------------------------------------------
# Design / result serialization
# --------------------------------------------------------------------------
def design_to_json(d: Design) -> dict:
    """Compact JSON form: placement permutation + upper-triangular links."""
    iu = np.triu_indices(d.adj.shape[0], 1)
    on = d.adj[iu]
    links = np.stack([iu[0][on], iu[1][on]], axis=1)
    return {"perm": d.perm.tolist(), "links": links.tolist()}


def _encode_floats(arr: np.ndarray) -> list:
    """Nested lists with RFC-8259-safe floats: NaN -> None, +/-inf ->
    "inf"/"-inf" (json.dump would otherwise emit bare ``NaN`` tokens —
    e.g. the history's phv column when ``track_phv`` is off — which strict
    parsers reject)."""
    def enc(x):
        if isinstance(x, list):
            return [enc(v) for v in x]
        if x != x:  # NaN
            return None
        if x == float("inf"):
            return "inf"
        if x == float("-inf"):
            return "-inf"
        return x

    return enc(np.asarray(arr, dtype=np.float64).tolist())


def _decode_floats(obj, shape_cols: int) -> np.ndarray:
    def dec(x):
        if isinstance(x, list):
            return [dec(v) for v in x]
        if x is None:
            return float("nan")
        if x == "inf":
            return float("inf")
        if x == "-inf":
            return float("-inf")
        return float(x)

    return np.asarray(dec(obj), dtype=np.float64).reshape(-1, shape_cols)


def design_from_json(obj: dict) -> Design:
    perm = np.asarray(obj["perm"], dtype=np.int32)
    n = perm.shape[0]
    adj = np.zeros((n, n), dtype=bool)
    for a, b in obj["links"]:
        adj[a, b] = adj[b, a] = True
    return Design(perm=perm, adj=adj)


@dataclasses.dataclass
class RunResult:
    """Outcome of one optimizer run through the unified API.

    ``designs``/``objs`` are the optimizer's final Pareto set (full
    ``N_OBJ``-dim objective rows; non-domination holds under ``obj_idx``).
    ``history`` is the SearchHistory array — rows of (wall_s, n_evals,
    best_edp_so_far, phv-or-nan). ``extra`` carries optimizer-specific
    diagnostics (convergence flags, PHV, eval errors, ...).
    """

    optimizer: str
    problem: dict
    budget: dict
    config: dict
    obj_idx: tuple[int, ...]
    designs: list[Design]
    objs: np.ndarray
    n_evals: int
    n_calls: int
    wall_s: float
    history: np.ndarray
    extra: dict = dataclasses.field(default_factory=dict)
    #: the run stopped on (or fully consumed) its budget — either the
    #: guard fired mid-driver or the evaluator counters reached the limits.
    exhausted: bool = False

    # ------------------------------------------------------------ queries
    def pareto_set(self) -> ParetoSet:
        return ParetoSet(list(self.designs), np.asarray(self.objs))

    def best_edp(self) -> float:
        """Best analytic network EDP proxy (lat x energy) on the Pareto set."""
        if len(self.designs) == 0:
            return float("inf")
        o = np.asarray(self.objs)
        return float(np.min(o[:, 2] * o[:, 3]))

    def phv(self) -> float:
        v = self.extra.get("phv")
        return float(v) if v is not None else float("nan")

    # --------------------------------------------------------------- (de)ser
    def to_json(self) -> dict:
        return {
            "optimizer": self.optimizer,
            "problem": self.problem,
            "budget": self.budget,
            # config may carry user-supplied numpy scalars / non-finite
            # floats via dict overrides — sanitize like extra.
            "config": _jsonable(self.config),
            "obj_idx": list(self.obj_idx),
            "designs": [design_to_json(d) for d in self.designs],
            "objs": _encode_floats(self.objs),
            "n_evals": int(self.n_evals),
            "n_calls": int(self.n_calls),
            "wall_s": float(self.wall_s),
            "history": _encode_floats(self.history),
            "extra": _jsonable(self.extra),
            "exhausted": bool(self.exhausted),
        }

    @staticmethod
    def from_json(obj: dict) -> "RunResult":
        return RunResult(
            optimizer=obj["optimizer"],
            problem=obj["problem"],
            budget=obj["budget"],
            config=obj["config"],
            obj_idx=tuple(obj["obj_idx"]),
            designs=[design_from_json(d) for d in obj["designs"]],
            objs=_decode_floats(obj["objs"], N_OBJ),
            n_evals=obj["n_evals"],
            n_calls=obj["n_calls"],
            wall_s=obj["wall_s"],
            history=_decode_floats(obj["history"], 4),
            extra=_decode_jsonable(obj.get("extra", {})),
            exhausted=obj.get("exhausted", False),
        )

    def save(self, path) -> None:
        with open(path, "w") as fh:
            # allow_nan=False: guarantee strict-parser-compatible output
            # (non-finite floats are already encoded by _encode_floats).
            json.dump(self.to_json(), fh, allow_nan=False)

    @staticmethod
    def load(path) -> "RunResult":
        with open(path) as fh:
            return RunResult.from_json(json.load(fh))


def _jsonable(obj):
    """Deep-convert numpy scalars/arrays and tuples to JSON-native types;
    non-finite floats get the same strict-JSON encoding as the arrays."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _jsonable(obj.tolist())
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return _encode_floats(np.asarray(float(obj)))
    return obj


def _decode_jsonable(obj):
    """Inverse of :func:`_jsonable`'s non-finite encoding for the ``extra``
    diagnostics dict (float-centric by convention: adapters must not store
    genuine ``None`` or the literal strings "inf"/"-inf" in it)."""
    if isinstance(obj, dict):
        return {k: _decode_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode_jsonable(v) for v in obj]
    if obj is None:
        return float("nan")
    if obj == "inf":
        return float("inf")
    if obj == "-inf":
        return float("-inf")
    return obj


# --------------------------------------------------------------------------
# The entry point
# --------------------------------------------------------------------------
def run(
    problem: NocProblem,
    optimizer: str = "stage",
    budget: Budget | None = None,
    config: Any = None,
    callback: Callable[[dict], None] | None = None,
    *,
    ev: Evaluator | None = None,
    ctx: PhvContext | None = None,
    track_phv: bool = False,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    device=None,
) -> RunResult:
    """Run ``optimizer`` (a registry name — see
    ``repro_torch.noc.optimizers``) on ``problem`` under ``budget``; returns
    a :class:`RunResult`.

    ``config`` is the optimizer's config dataclass, a dict of overrides for
    it, or None for defaults. ``callback`` streams one telemetry dict per
    recorded evaluation. ``ev``/``ctx`` inject a prebuilt evaluator/PHV
    context; by default both are built fresh on ``device`` (default
    ``"cuda"``; raises when no card is present).

    ``checkpoint_dir``/``resume`` enable crash-safe per-round checkpoints
    for coordinator optimizers that support them (``stage_dist`` with
    ``sync_every >= 1``): state is persisted atomically after every sync
    round, and ``resume=True`` restores the latest round and continues,
    byte-identical to the uninterrupted run.
    """
    from .optimizers import get_optimizer, make_config

    entry = get_optimizer(optimizer)
    budget = budget or Budget()
    cfg = make_config(entry, config)

    if checkpoint_dir is not None or resume:
        if not entry.owns_result or not hasattr(cfg, "checkpoint_dir"):
            raise ValueError(
                f"optimizer {entry.name!r} does not support checkpoint_dir/"
                "resume (round checkpoints are a coordinator feature)")
        updates: dict[str, Any] = {}
        if checkpoint_dir is not None:
            updates["checkpoint_dir"] = checkpoint_dir
        if resume:
            updates["resume"] = True
        # replace() re-runs __post_init__, so the knob combination is
        # validated exactly as if it had been in `config` to begin with.
        cfg = dataclasses.replace(cfg, **updates)

    if entry.owns_result:
        # Coordinator drivers (e.g. "stage_dist") run their evaluations on
        # evaluators this function cannot see — other processes or
        # devices — so they own accounting, history, and budget
        # enforcement and return a complete RunResult. No evaluator is
        # built here: the workers build their own.
        if ev is not None or ctx is not None:
            raise ValueError(
                f"optimizer {entry.name!r} owns its RunResult; ev=/ctx= "
                "injection is not supported (workers build their own)")
        if callback is not None or track_phv:
            raise ValueError(
                f"optimizer {entry.name!r} owns its RunResult; callback=/"
                "track_phv= are not supported across worker boundaries")
        return entry.run_fn(problem, budget, cfg, device)

    base_ev = ev if ev is not None else problem.evaluator(device=device)
    n_evals0, n_calls0 = base_ev.n_evals, base_ev.n_calls
    guarded = BudgetedEvaluator(base_ev, budget)
    # The fallback Pareto set is only worth maintaining when the guard can
    # fire with designs already recorded: under a pure max_evals budget the
    # native drivers admit the guard only on their first dispatch (nothing
    # recorded yet — the fallback would be empty regardless), so only a
    # max_calls limit or a driver without native budget support (PCBB)
    # justifies the per-record merge upkeep.
    guard_can_fire = (
        (budget.max_evals is not None and not entry.native_max_evals)
        or budget.max_calls is not None)

    recorder = None
    exhausted = False
    t0 = time.perf_counter()
    try:
        if ctx is None:
            # Through the guard: the PHV-anchoring mesh evaluation counts
            # against (and is forbidden by) a zero budget like any other.
            ctx = problem.context(guarded)
        recorder = RunRecorder(base_ev, ctx, callback=callback,
                               track_phv=track_phv,
                               keep_pareto=guard_can_fire)
        t0 = time.perf_counter()  # optimizer-only wall clock; setup excluded
        pareto, extra = entry.run_fn(problem, budget, cfg, guarded, ctx,
                                     recorder)
    except BudgetExhausted:
        pareto = recorder.pareto if recorder is not None else ParetoSet.empty()
        extra, exhausted = {}, True
    wall = time.perf_counter() - t0
    # A run that consumed its whole budget reports exhausted=True whether
    # its own check stopped it or the guard did.
    if budget.max_evals is not None and base_ev.n_evals >= budget.max_evals:
        exhausted = True
    if budget.max_calls is not None and base_ev.n_calls >= budget.max_calls:
        exhausted = True

    extra = dict(extra)
    extra.setdefault("phv",
                     ctx.phv(pareto.objs) if ctx is not None else 0.0)
    return RunResult(
        optimizer=entry.name,
        problem=problem.to_json(),
        budget=budget.to_json(),
        config=dataclasses.asdict(cfg),
        obj_idx=tuple(ctx.obj_idx) if ctx is not None else problem.obj_idx,
        designs=list(pareto.designs),
        objs=np.asarray(pareto.objs, dtype=np.float64),
        n_evals=base_ev.n_evals - n_evals0,
        n_calls=base_ev.n_calls - n_calls0,
        wall_s=wall,
        history=(recorder.as_array() if recorder is not None
                 else np.zeros((0, 4))),
        extra=extra,
        exhausted=exhausted,
    )
