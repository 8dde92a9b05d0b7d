"""Deterministic fault injection for the distributed layer.

Every degradation path the resilience substrate promises — deadline
trips, bounded retries, spawn-pool rebuilds, corrupt-payload rejection,
mid-run coordinator death — is pinned by tests *through this module*
rather than asserted in prose. A :class:`FaultInjector` is plain data
(a tuple of fault dicts plus an optional seeded random crash rate), so
it pickles into spawn children and serializes into a
``StageDistConfig`` / ``RunResult.config`` unchanged.

Fault dicts::

    {"kind": "crash",   "worker_id": 1, "round": 0, "attempt": 0}
    {"kind": "abort",   "worker_id": 1, "round": 0, "attempt": 0}
    {"kind": "hang",    "worker_id": 2, "round": 1, "attempt": 0,
     "hang_s": 3.0}
    {"kind": "corrupt", "worker_id": 0, "round": 0, "attempt": 0}
    {"kind": "kill_coordinator", "round": 1}

``worker_id: None`` (or omitted) matches every worker; ``round`` and
``attempt`` default to 0 and must match exactly — which is what makes a
fault a *scripted point event*: the retry of a crashed attempt (a new
``attempt``) runs clean unless another fault targets it.

Kinds:

``crash``
    Raise :class:`InjectedFault` in place of the shard function — an
    ordinary worker exception (retriable, recorded with traceback).
``abort``
    A *hard* death. In a spawn child: ``os._exit`` — the real
    ``BrokenProcessPool`` path, poisoning the pool exactly like a
    segfault. In-process executors have no survivable equivalent, so it
    degrades to ``crash`` (documented, not hidden).
``hang``
    Sleep ``hang_s`` seconds before running the shard — drives the
    deadline path: preemptive ``fut.result(timeout=)`` + pool rebuild
    under the process executor, post-hoc elapsed check in-process.
``corrupt``
    Return a mangled payload instead of running the shard — drives the
    coordinator-side payload validation (phase ``"validate"``).
``kill_coordinator``
    Consulted by :func:`repro_torch.dist.sync.run_synced` at the round
    boundary *after* the round checkpoint is saved: raises
    :class:`CoordinatorKilled`, the seam the interrupt/resume
    determinism tests pull.

Service-level kinds (consumed by :mod:`repro_torch.noc.server`, never matched
against worker dispatches)::

    {"kind": "reject_admission", "tenant": "t0", "request": None}
    {"kind": "slow_tenant",      "tenant": "t1", "wave": 2, "hang_s": 3.0}
    {"kind": "kill_server",      "wave": 1}

``reject_admission``
    Matched at submit time (``tenant``/``request`` — ``None`` matches
    any): the admission layer returns its structured rejection error,
    driving the client-visible error path without crafting a malformed
    problem.
``slow_tenant``
    Adds ``hang_s`` to the matched tenant's shard dispatches in wave
    ``wave`` — a slow tenant exercises per-request deadline degradation
    and must *not* stall other tenants' rounds.
``kill_server``
    Consulted by the service after wave ``wave``'s journal + checkpoints
    hit disk: raises :class:`ServerKilled`, the seam the service
    crash-recovery tests pull (mirror of ``kill_coordinator``).

The seeded random mode (``p_crash`` > 0) draws one uniform per
``(seed, worker_id, round, attempt)`` position via ``SeedSequence`` —
deterministic chaos, independent of dispatch order.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import time

import numpy as np

FAULT_KINDS = ("crash", "abort", "hang", "corrupt", "kill_coordinator")

#: kinds acted out by the service layer (repro_torch.noc.server), not at the
#: worker boundary — FaultInjector.match() skips them like
#: kill_coordinator, so a mixed script threads through both layers.
SERVICE_FAULT_KINDS = ("reject_admission", "slow_tenant", "kill_server")

_WORKER_ONLY_KEYS = {"worker_id", "round", "attempt"}
_SERVICE_ONLY_KEYS = {"tenant", "request", "wave"}

#: payload returned by a "corrupt" fault — fails any structural
#: validation (it is not a RunResult / round payload), which is the point.
CORRUPT_PAYLOAD = {"__corrupt__": "injected payload corruption"}


class InjectedFault(RuntimeError):
    """The exception a scripted ``crash`` (or in-process ``abort``) raises."""


class CoordinatorKilled(RuntimeError):
    """Raised at a sync-round boundary by a ``kill_coordinator`` fault —
    stands in for the coordinator process dying after the round's
    checkpoint hit disk. Resume with ``StageDistConfig(resume=True)``."""


class ServerKilled(RuntimeError):
    """Raised at a service wave boundary by a ``kill_server`` fault —
    stands in for the server process dying after the wave's journal and
    per-request checkpoints hit disk. Restarting the service against the
    same journal directory resumes every in-flight request."""


def check_faults(faults) -> None:
    """Validate a fault list at config construction (not mid-run, after
    evaluation budget has been spent on the rounds before the typo)."""
    all_kinds = FAULT_KINDS + SERVICE_FAULT_KINDS
    for f in faults or ():
        if not isinstance(f, dict):
            raise ValueError(f"each fault must be a dict, got {type(f).__name__}")
        kind = f.get("kind")
        if kind not in all_kinds:
            raise ValueError(
                f"fault kind must be one of {all_kinds}, got {kind!r}")
        service = kind in SERVICE_FAULT_KINDS
        for key in ("round", "attempt", "wave"):
            if int(f.get(key, 0)) < 0:
                raise ValueError(f"fault {key} must be >= 0, got {f[key]}")
        if f.get("worker_id") is not None and int(f["worker_id"]) < 0:
            raise ValueError(
                f"fault worker_id must be >= 0 or None, got {f['worker_id']}")
        for key in ("tenant", "request"):
            if f.get(key) is not None and not isinstance(f[key], str):
                raise ValueError(
                    f"fault {key} must be a string or None, got {f[key]!r}")
        if float(f.get("hang_s", 0.0)) < 0:
            raise ValueError(f"fault hang_s must be >= 0, got {f['hang_s']}")
        allowed = {"kind", "hang_s"} | (
            _SERVICE_ONLY_KEYS if service else _WORKER_ONLY_KEYS)
        unknown = set(f) - allowed
        if unknown:
            raise ValueError(f"unknown fault keys {sorted(unknown)} in {f}")


@dataclasses.dataclass(frozen=True)
class FaultInjector:
    """Plain-data fault script: scripted point faults plus an optional
    seeded random crash rate. Picklable (crosses the spawn boundary) and
    JSON-trivial (lives inside ``StageDistConfig.faults``)."""

    faults: tuple = ()
    p_crash: float = 0.0
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults or ()))
        check_faults(self.faults)
        if not 0.0 <= self.p_crash <= 1.0:
            raise ValueError(f"p_crash must be in [0, 1], got {self.p_crash}")

    # ------------------------------------------------------------ matching
    def match(self, worker_id: int, round_idx: int, attempt: int) -> dict | None:
        """First scripted fault targeting this (worker, round, attempt)
        dispatch, or a synthesized crash from the seeded random mode."""
        for f in self.faults:
            if (f["kind"] == "kill_coordinator"
                    or f["kind"] in SERVICE_FAULT_KINDS):
                continue
            wid = f.get("worker_id")
            if wid is not None and int(wid) != int(worker_id):
                continue
            if int(f.get("round", 0)) != int(round_idx):
                continue
            if int(f.get("attempt", 0)) != int(attempt):
                continue
            return f
        if self.p_crash > 0.0:
            ss = np.random.SeedSequence(
                [int(self.seed), int(worker_id), int(round_idx), int(attempt)])
            if np.random.default_rng(ss).random() < self.p_crash:
                return {"kind": "crash", "worker_id": int(worker_id),
                        "round": int(round_idx), "attempt": int(attempt)}
        return None

    def kills_coordinator(self, round_idx: int) -> bool:
        return any(f["kind"] == "kill_coordinator"
                   and int(f.get("round", 0)) == int(round_idx)
                   for f in self.faults)

    # --------------------------------------------------- service matching
    def _match_service(self, kind: str, tenant: str,
                       request: str) -> dict | None:
        for f in self.faults:
            if f["kind"] != kind:
                continue
            if f.get("tenant") is not None and f["tenant"] != str(tenant):
                continue
            if f.get("request") is not None and f["request"] != str(request):
                continue
            return f
        return None

    def rejects_admission(self, tenant: str, request: str) -> dict | None:
        """Scripted ``reject_admission`` targeting this submit (``tenant``
        / ``request`` keys, ``None`` = any), consulted by the service's
        admission layer before validation."""
        return self._match_service("reject_admission", tenant, request)

    def slow_tenant_delay(self, tenant: str, request: str,
                          wave: int) -> float:
        """Seconds of injected per-dispatch delay for this tenant's
        shards in service wave ``wave`` (0.0 when unmatched)."""
        for f in self.faults:
            if f["kind"] != "slow_tenant":
                continue
            if f.get("tenant") is not None and f["tenant"] != str(tenant):
                continue
            if f.get("request") is not None and f["request"] != str(request):
                continue
            if int(f.get("wave", 0)) != int(wave):
                continue
            return float(f.get("hang_s", 0.0))
        return 0.0

    def kills_server(self, wave: int) -> bool:
        """True when a ``kill_server`` fault targets service wave
        ``wave`` — consulted after the wave's journal/checkpoints save."""
        return any(f["kind"] == "kill_server"
                   and int(f.get("wave", 0)) == int(wave)
                   for f in self.faults)


def call_with_faults(injector: FaultInjector | None, worker_id: int,
                     round_idx: int, attempt: int, fn, args: tuple):
    """Run ``fn(*args)`` under the injector — THE worker-boundary wrapper.

    Module-level so the process executor can pickle it by reference and
    act faults out *inside the child* (an ``abort`` really breaks the
    pool; a ``hang`` really occupies a pool slot until the coordinator's
    deadline kills it). ``injector=None`` is the zero-overhead no-fault
    path: a plain ``fn(*args)``.
    """
    if injector is not None:
        act = injector.match(worker_id, round_idx, attempt)
        if act is not None:
            kind = act["kind"]
            where = (f"worker {worker_id}, round {round_idx}, "
                     f"attempt {attempt}")
            if kind == "crash":
                raise InjectedFault(f"injected crash ({where})")
            if kind == "abort":
                if multiprocessing.parent_process() is not None:
                    os._exit(134)  # hard child death -> BrokenProcessPool
                raise InjectedFault(
                    f"injected abort ({where}); in-process executors have "
                    "no survivable hard-death, degraded to crash")
            if kind == "corrupt":
                return dict(CORRUPT_PAYLOAD)
            if kind == "hang":
                time.sleep(float(act.get("hang_s", 0.0)))
    return fn(*args)
