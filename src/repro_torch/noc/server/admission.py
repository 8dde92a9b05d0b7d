"""Admission control for the NoC-optimization service.

Everything a request can get wrong is rejected HERE, at the door, as a
structured error — never by crashing a worker after fleet budget was
spent on it. Three layers:

* **validation** — the submitted ``(problem, budget, config)`` JSON is
  deserialized through the same canonicalizing ``from_json`` paths the
  shard boundary uses; anything that does not round-trip is an
  ``invalid_problem`` / ``invalid_budget`` / ``invalid_config``
  rejection carrying the parse error. Config keys the service owns
  (checkpointing, fault scripts) are rejected explicitly rather than
  silently dropped.
* **backpressure** — a bounded request queue (``queue_full``) and a
  per-tenant in-flight cap (``tenant_cap``), both checked before any
  state is allocated.
* **canonical request keys** — :func:`canonical_request_key` hashes the
  canonicalized problem/budget JSON plus the trajectory-shaping config
  fields (:data:`repro_torch.dist.state.TRAJECTORY_FIELDS`). Two requests get
  the same key iff they would produce the same result: dict ordering,
  float spelling (``2`` vs ``2.0`` both parse to the same float), and
  omitted back-compat defaults all hash identically, while a different
  seed (inside the budget) or any trajectory knob does not. The key is
  the result-cache identity — a duplicate request costs zero evals.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from ...core.traffic import TrafficValidationError
from ...dist.state import TRAJECTORY_FIELDS
from ..api import Budget, NocProblem
from ..optimizers import StageDistConfig

#: request-config keys owned by the service: checkpoints live under the
#: service journal, fault scripts come from the ServiceConfig, and
#: executor placement is a fleet property. A request naming any of these
#: is confused about the contract — reject loudly.
SERVICE_OWNED_KEYS = ("checkpoint_dir", "resume", "faults", "executor")


class AdmissionRejected(ValueError):
    """A request the service refuses to run, with a machine-readable
    ``code`` — the structured-error contract of the admission layer."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = str(code)

    def to_json(self) -> dict:
        return {"error": {"code": self.code, "message": str(self)}}


def validate_request(problem_json, budget_json, config_json=None,
                     ) -> tuple[NocProblem, Budget, StageDistConfig]:
    """Deserialize and canonicalize one request, or raise
    :class:`AdmissionRejected` with the layer that failed.

    The returned config is NOT yet fleet-normalized (executor, resilience
    knobs) — that is the service's job; this only proves the request is
    well-formed enough to ever run."""
    if not isinstance(problem_json, dict):
        raise AdmissionRejected(
            "invalid_problem",
            f"problem must be a JSON object, got {type(problem_json).__name__}")
    try:
        problem = NocProblem.from_json(problem_json)
    except TrafficValidationError as exc:
        # bad traffic content (NaN/negative/zero-sum matrix, unknown
        # model/phase/app name, non-tiling mesh) — distinct from a
        # structurally malformed problem so clients can tell them apart.
        raise AdmissionRejected("invalid_traffic", str(exc))
    except Exception as exc:  # noqa: BLE001 — anything malformed lands here
        raise AdmissionRejected(
            "invalid_problem",
            f"problem does not deserialize: {type(exc).__name__}: {exc}")
    if not isinstance(budget_json, dict):
        raise AdmissionRejected(
            "invalid_budget",
            f"budget must be a JSON object, got {type(budget_json).__name__}")
    try:
        budget = Budget.from_json(budget_json)
    except Exception as exc:  # noqa: BLE001
        raise AdmissionRejected(
            "invalid_budget",
            f"budget does not deserialize: {type(exc).__name__}: {exc}")
    if budget.max_evals is None and budget.max_calls is None:
        raise AdmissionRejected(
            "invalid_budget",
            "service requests must be bounded: set max_evals and/or "
            "max_calls (an unbounded request would hold fleet slots forever)")
    config_json = config_json or {}
    if not isinstance(config_json, dict):
        raise AdmissionRejected(
            "invalid_config",
            f"config must be a JSON object, got {type(config_json).__name__}")
    owned = [k for k in SERVICE_OWNED_KEYS if k in config_json]
    if owned:
        raise AdmissionRejected(
            "invalid_config",
            f"config keys {owned} are service-owned (checkpointing, fault "
            "policy, and executor placement are fleet properties); remove "
            "them from the request")
    try:
        cfg = StageDistConfig(**config_json)
    except Exception as exc:  # noqa: BLE001
        raise AdmissionRejected(
            "invalid_config",
            f"config rejected: {type(exc).__name__}: {exc}")
    return problem, budget, cfg


def _canon(x):
    """Numeric canonicalization for the cache key: an integral float
    (``120.0``, ``1.2e2``) hashes like the int ``120`` — JSON spelling
    must not split the cache. Fractional floats are stable already
    (json.dumps emits the shortest round-trip repr)."""
    if isinstance(x, float) and x.is_integer():
        return int(x)
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    return x


def canonical_request_key(problem: NocProblem, budget: Budget,
                          cfg: StageDistConfig) -> str:
    """The result-cache identity of a request (stable sha256 hex digest).

    Hashes the *canonicalized* JSON (``to_json`` after ``from_json`` has
    filled back-compat defaults), serialized with sorted keys — so dict
    ordering and float spelling in the submitted text cannot split the
    cache — plus exactly the config fields that shape the search
    trajectory. Fleet knobs (executor, deadlines, retries) change where
    and how fast a request runs, never what it returns, and are
    deliberately excluded; the seed is inside the budget."""
    ident = _canon({
        "problem": problem.to_json(),
        "budget": budget.to_json(),
        "plan": {f: getattr(cfg, f) for f in TRAJECTORY_FIELDS},
    })
    blob = json.dumps(ident, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def normalize_config(cfg: StageDistConfig, *, executor: str,
                     shard_timeout_s: float | None, max_retries: int,
                     retry_backoff_s: float) -> StageDistConfig:
    """Fleet-normalize an admitted request config: placement and
    resilience knobs come from the service, ``sync_every`` is clamped to
    >= 1 (the service multiplexes requests at sync-round granularity —
    an unsynced request would hold its slots for the whole run), and the
    service-owned fields are forced to their inert values."""
    return dataclasses.replace(
        cfg, executor=executor, sync_every=max(1, cfg.sync_every),
        shard_timeout_s=shard_timeout_s, max_retries=max_retries,
        retry_backoff_s=retry_backoff_s,
        checkpoint_dir=None, resume=False, faults=())
