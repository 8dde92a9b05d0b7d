"""The multi-tenant NoC-optimization service core.

:class:`NocService` accepts many concurrent ``(NocProblem, Budget)``
requests and multiplexes them over ONE shared worker fleet. Each
admitted request is a :class:`repro_torch.dist.state.SyncRunState` — the same
resumable round state machine ``stage_dist`` runs on — and the service
is a deterministic *wave pump*: each :meth:`step` builds the next round
of every running request, dispatches all of them as a single
:func:`repro_torch.dist.worker.execute_shards` wave over the fleet, then
routes the results back and absorbs them per request. Requests at
different rounds interleave freely (the worker-order-independent Pareto
union makes cross-request ordering irrelevant), a slow or faulted
request delays only its own rounds' slots, and the whole service is
single-threaded and deterministic — chaos tests replay exactly.

Robustness layers (the spine of this module):

* admission control + backpressure — :mod:`.admission`; checked before
  any state is allocated, rejections are structured errors.
* per-request deadlines — ``deadline_s`` is a wall-clock budget metered
  across waves (and across server restarts, via the journal); an
  overdue or cancelled request is finalized as its best-so-far front
  with ``extra["partial"] = True`` instead of an error, and its fleet
  slots are reclaimed (its rounds simply stop being built).
* fleet supervision — per-shard deadlines, bounded reseeded retries and
  spawn-pool rebuild are the ``execute_shards`` machinery, applied
  per wave; a failed shard charges the owning request's ledger (wave
  meta tags are ``seq * ROUND_TAG_STRIDE + worker_id``, so concurrent
  requests at the same round never alias) and never stalls other
  tenants.
* crash-safe journal — every request's admission record and per-round
  checkpoint hit disk (atomically) before the wave is acknowledged; a
  killed-and-restarted service resumes every in-flight request from its
  last round and replays nothing completed (:meth:`NocService.recover`
  runs in the constructor).
* result cache — completed results are deduplicated on the canonical
  request key; a duplicate request is served at submit time with
  ``n_evals == 0`` (the original paid the evals) and
  ``extra["cache_hit"] = True``.

Service-level fault kinds (``reject_admission`` / ``slow_tenant`` /
``kill_server`` — :mod:`repro_torch.dist.faults`) act at the matching seams,
making every one of those layers deterministically testable.

The fleet runs on ``ServiceConfig.device`` (``"cuda"`` unless told
otherwise; the service raises at construction when no card is present).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from ...dist import package_dist_result
from ...dist.ckpt import RoundCheckpointer
from ...dist.faults import (FAULT_KINDS, FaultInjector, ServerKilled,
                               check_faults)
from ...dist.state import (ROUND_TAG_STRIDE, SyncRunState,
                              reseed_round_args)
from ...dist.sync import validate_round_payload
from ...dist.worker import ShardPool, check_executor, shard_pool
from ..api import Budget, NocProblem, RunResult
from ..optimizers import StageDistConfig

from .admission import (AdmissionRejected, canonical_request_key,
                        normalize_config, validate_request)
from .journal import TERMINAL, RequestJournal


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Fleet + policy knobs of one :class:`NocService`.

    ``n_workers`` is the fleet size (process-pool slots; also the default
    shard count a request is planned across). ``max_queue`` bounds the
    live (queued + running) request count — the backpressure knob — and
    ``max_inflight_per_tenant`` keeps one tenant from occupying the
    whole queue. ``shard_timeout_s`` / ``max_retries`` /
    ``retry_backoff_s`` apply per wave to every tenant's dispatches
    (fleet policy, not request policy). ``faults`` is a deterministic
    chaos script: worker kinds act at the shard boundary, service kinds
    at the admission/wave seams. ``device`` is where the fleet's shards
    run: ``"cuda"`` (the ``cuda`` executor spreads shards over every
    visible card) or ``"cpu"``."""

    n_workers: int = 4
    executor: str = "serial"
    journal_dir: str | None = None
    max_queue: int = 16
    max_inflight_per_tenant: int = 2
    shard_timeout_s: float | None = None
    max_retries: int = 1
    retry_backoff_s: float = 0.0
    cache: bool = True
    keep_completed: int = 4
    faults: tuple = ()
    device: str = "cuda"

    def __post_init__(self):
        check_executor(self.executor)
        if torch.device(self.device).type not in ("cuda", "cpu"):
            raise ValueError(
                f"device must be a CUDA device or 'cpu', got {self.device!r}")
        object.__setattr__(self, "faults", tuple(self.faults or ()))
        check_faults(self.faults)
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_inflight_per_tenant < 1:
            raise ValueError(f"max_inflight_per_tenant must be >= 1, "
                             f"got {self.max_inflight_per_tenant}")
        if self.shard_timeout_s is not None and self.shard_timeout_s <= 0:
            raise ValueError(f"shard_timeout_s must be > 0 or None, "
                             f"got {self.shard_timeout_s}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {self.retry_backoff_s}")
        if self.keep_completed < 0:
            raise ValueError(
                f"keep_completed must be >= 0, got {self.keep_completed}")


class _Request:
    """One tenant request: journal record + live state machine."""

    def __init__(self, rec: dict, problem: NocProblem, budget: Budget,
                 cfg: StageDistConfig):
        self.rec = rec
        self.problem = problem
        self.budget = budget
        self.cfg = cfg
        self.sm: SyncRunState | None = None
        self.ckpt: RoundCheckpointer | None = None
        self.result: RunResult | None = None

    @property
    def status(self) -> str:
        return self.rec["status"]

    @property
    def live(self) -> bool:
        return self.rec["status"] in ("queued", "running")


class NocService:
    """Long-running multi-tenant optimization service (see module doc).

    Single-threaded by design: :meth:`submit`/:meth:`cancel` mutate
    request state, :meth:`step` advances every running request by one
    sync round via one fleet wave. The stdio/CLI front end
    (:mod:`repro_torch.noc.server.client`) pumps :meth:`step` between
    protocol messages; in-process users call :meth:`run_until_idle`.
    """

    def __init__(self, cfg: ServiceConfig):
        from ...device import resolve_device

        self.cfg = cfg
        self.device = str(resolve_device(cfg.device))
        self.injector = (FaultInjector(faults=cfg.faults)
                         if cfg.faults else None)
        self.journal = (RequestJournal(cfg.journal_dir)
                        if cfg.journal_dir else None)
        self._requests: dict[str, _Request] = {}
        self._cache: dict[str, RunResult] = {}
        self._wave = 0
        self._stack = contextlib.ExitStack()
        self._pool = self._stack.enter_context(
            shard_pool(cfg.executor, cfg.n_workers, self.device))
        self.recover()

    # ------------------------------------------------------------ recovery
    def recover(self) -> None:
        """Rebuild service state from the journal (no-op without one):
        terminal requests feed the cache, ``queued`` requests re-queue,
        ``running`` requests restore their round checkpoints. A request
        whose ``result.json`` exists but whose status never flipped
        terminal (crash in the finalize window) is adopted as completed —
        the result write is the commit point, so nothing replays."""
        if self.journal is None:
            return
        for rec in self.journal.load_all():
            rid = rec["id"]
            req = _Request(rec, NocProblem.from_json(rec["problem"]),
                           Budget.from_json(rec["budget"]),
                           StageDistConfig(**rec["config"]))
            self._requests[rid] = req
            result_json = self.journal.load_result(int(rec["seq"]))
            if result_json is not None:
                req.result = RunResult.from_json(result_json)
                if rec["status"] not in TERMINAL:
                    # Crash between result write and status flip.
                    rec["status"] = ("partial"
                                     if req.result.extra.get("partial")
                                     else "done")
                    self.journal.save_request(rec)
                if self.cfg.cache and not req.result.extra.get("partial") \
                        and not req.result.extra.get("cache_hit"):
                    self._cache.setdefault(rec["key"], req.result)
                continue
            if rec["status"] in TERMINAL:
                continue                       # error/cancelled: nothing to do
            if rec["status"] == "running":
                self._start(req)
                if req.ckpt is not None and req.ckpt.rounds():
                    req.sm.restore(req.ckpt.load_round())
                # else: admitted but died before round 0 saved — the
                # fresh state machine re-runs it from scratch, which is
                # byte-identical (nothing of it ever reached a result).

    def _start(self, req: _Request) -> None:
        """queued -> running: build the state machine + its checkpointer."""
        req.sm = SyncRunState(req.problem, req.budget, req.cfg)
        if self.journal is not None:
            req.ckpt = RoundCheckpointer(
                self.journal.rounds_dir(int(req.rec["seq"])))
        req.rec["status"] = "running"
        self._persist(req)

    def _persist(self, req: _Request) -> None:
        if self.journal is not None:
            self.journal.save_request(req.rec)

    # ------------------------------------------------------------ admission
    def submit(self, problem_json, budget_json, config_json=None, *,
               tenant: str = "default", deadline_s: float | None = None,
               request_id: str | None = None) -> dict:
        """Admit one request; returns ``{"id", "status", "cache_hit"}``
        or ``{"error": {"code", "message"}}`` — never raises for a bad
        request (the structured-error contract)."""
        tenant = str(tenant)
        seq = (self.journal.next_seq() if self.journal is not None
               else len(self._requests))
        rid = str(request_id) if request_id is not None else f"req_{seq:06d}"
        if rid in self._requests:
            return AdmissionRejected(
                "duplicate_id", f"request id {rid!r} already exists"
            ).to_json()
        if self.injector is not None:
            inj = self.injector.rejects_admission(tenant, rid)
            if inj is not None:
                return AdmissionRejected(
                    "injected_rejection",
                    f"admission rejected by fault script ({inj})").to_json()
        live = [r for r in self._requests.values() if r.live]
        if len(live) >= self.cfg.max_queue:
            return AdmissionRejected(
                "queue_full",
                f"service queue is full ({len(live)}/{self.cfg.max_queue} "
                "live requests); retry after a drain").to_json()
        if sum(1 for r in live if r.rec["tenant"] == tenant) \
                >= self.cfg.max_inflight_per_tenant:
            return AdmissionRejected(
                "tenant_cap",
                f"tenant {tenant!r} already has "
                f"{self.cfg.max_inflight_per_tenant} requests in flight"
            ).to_json()
        if deadline_s is not None and float(deadline_s) <= 0:
            return AdmissionRejected(
                "invalid_deadline",
                f"deadline_s must be > 0 or None, got {deadline_s}").to_json()
        try:
            problem, budget, rcfg = validate_request(
                problem_json, budget_json, config_json)
        except AdmissionRejected as exc:
            return exc.to_json()
        cfg = normalize_config(
            rcfg, executor=self.cfg.executor,
            shard_timeout_s=self.cfg.shard_timeout_s,
            max_retries=self.cfg.max_retries,
            retry_backoff_s=self.cfg.retry_backoff_s)
        key = canonical_request_key(problem, budget, cfg)
        rec = {
            "id": rid, "seq": int(seq), "tenant": tenant,
            "status": "queued", "problem": problem.to_json(),
            "budget": budget.to_json(),
            "config": dataclasses.asdict(cfg),
            "deadline_s": (float(deadline_s)
                           if deadline_s is not None else None),
            "key": key, "wall_spent_s": 0.0, "error": None,
        }
        req = _Request(rec, problem, budget, cfg)
        self._requests[rid] = req

        if self.cfg.cache and key in self._cache:
            # Duplicate request: served at the door. The cached result's
            # designs/front are returned verbatim; the eval/call charge
            # is zeroed because THIS request spent none (the original
            # request's ledger holds the real cost).
            hit = self._cache[key]
            req.result = dataclasses.replace(
                hit, n_evals=0, n_calls=0, wall_s=0.0,
                extra=dict(hit.extra, cache_hit=True))
            rec["status"] = "done"
            if self.journal is not None:
                self.journal.save_result(int(seq), req.result.to_json())
            self._persist(req)
            return {"id": rid, "status": "done", "cache_hit": True}

        self._persist(req)
        return {"id": rid, "status": "queued", "cache_hit": False}

    # ------------------------------------------------------------- queries
    def status(self, request_id: str | None = None) -> dict:
        if request_id is None:
            counts: dict[str, int] = {}
            for req in self._requests.values():
                counts[req.status] = counts.get(req.status, 0) + 1
            return {"requests": len(self._requests), "by_status": counts,
                    "wave": self._wave, "cache_entries": len(self._cache)}
        req = self._requests.get(str(request_id))
        if req is None:
            return AdmissionRejected(
                "unknown_request", f"no request {request_id!r}").to_json()
        return {"id": req.rec["id"], "tenant": req.rec["tenant"],
                "status": req.status,
                "rounds_done": req.sm.next_round if req.sm else 0,
                "wall_spent_s": req.rec["wall_spent_s"],
                "error": req.rec.get("error")}

    def result(self, request_id: str) -> RunResult | dict:
        """The finished :class:`RunResult`, or a structured error dict
        for unknown/unfinished/errored requests."""
        req = self._requests.get(str(request_id))
        if req is None:
            return AdmissionRejected(
                "unknown_request", f"no request {request_id!r}").to_json()
        if req.result is None:
            code = ("request_failed" if req.status in ("error", "cancelled")
                    else "not_finished")
            return AdmissionRejected(
                code, f"request {request_id!r} is {req.status}: "
                      f"{req.rec.get('error') or 'no result available'}"
            ).to_json()
        return req.result

    def cancel(self, request_id: str) -> dict:
        """Cancel a live request: queued requests terminate immediately,
        running ones finalize as their partial best-so-far front. Fleet
        slots are reclaimed — the next wave simply no longer builds its
        rounds."""
        req = self._requests.get(str(request_id))
        if req is None:
            return AdmissionRejected(
                "unknown_request", f"no request {request_id!r}").to_json()
        if not req.live:
            return self.status(request_id)
        if req.sm is None:                     # queued: nothing ran yet
            req.rec["status"] = "cancelled"
            req.rec["error"] = "cancelled before dispatch"
            self._persist(req)
        else:
            self._finalize(req, partial=True, note="cancelled")
        return self.status(request_id)

    # ---------------------------------------------------------- wave pump
    def step(self) -> bool:
        """Advance every running request by one sync round via one fleet
        wave; returns whether any request is still live. Deterministic:
        requests advance in admission order, shards in worker order."""
        wave = self._wave
        self._wave += 1
        t0 = time.perf_counter()

        for req in list(self._requests.values()):
            if req.status == "queued":
                self._start(req)
        running = [r for r in self._requests.values()
                   if r.status == "running"]

        # Deadlines are checked before building: an overdue request's
        # slots go to the tenants that still have time.
        for req in running:
            dl = req.rec.get("deadline_s")
            if dl is not None and req.rec["wall_spent_s"] >= dl:
                self._finalize(req, partial=True, note="deadline")
        running = [r for r in running if r.status == "running"]

        tasks: list[tuple] = []
        meta: list[tuple[int, int]] = []
        spans: list[tuple[_Request, int, list[int], int, int]] = []
        for req in running:
            sm = req.sm
            if sm.done:
                self._finalize(req)
                continue
            r = sm.next_round
            built = sm.build_round(r)
            if built is None:
                self._save_round(req, r, done=True)
                self._finalize(req)
                continue
            req_tasks, dispatched = built
            if not req_tasks:
                cont = sm.skip_round(r)
                self._save_round(req, r, done=not cont)
                if not cont:
                    self._finalize(req)
                continue
            lo = len(tasks)
            tasks.extend(req_tasks)
            seq = int(req.rec["seq"])
            meta.extend((seq * ROUND_TAG_STRIDE + wid, r)
                        for wid in dispatched)
            spans.append((req, r, dispatched, lo, len(tasks)))

        if tasks:
            from ...dist import worker as _worker

            results, failures = _worker.execute_shards(
                _worker.run_shard_round, tasks, self.cfg.executor,
                pool=self._pool, device=self.device, meta=meta,
                timeout_s=self.cfg.shard_timeout_s,
                max_retries=self.cfg.max_retries,
                backoff_s=self.cfg.retry_backoff_s,
                retry_args=reseed_round_args,
                injector=self._wave_injector(spans, wave),
                validate=validate_round_payload)
            elapsed = time.perf_counter() - t0
            for req, r, dispatched, lo, hi in spans:
                req_results = {i - lo: results[i]
                               for i in results if lo <= i < hi}
                req_failures = {}
                for i in failures:
                    if not lo <= i < hi:
                        continue
                    recs = []
                    for rec in failures[i]:
                        rec = dict(rec)
                        # Untag the wave id back to the fleet worker id —
                        # the request's ledger speaks worker terms.
                        rec["worker_id"] = int(
                            rec["worker_id"]) % ROUND_TAG_STRIDE
                        recs.append(rec)
                    req_failures[i - lo] = recs
                cont = req.sm.absorb_round(r, dispatched, req_results,
                                           req_failures)
                req.rec["wall_spent_s"] = (
                    float(req.rec["wall_spent_s"]) + elapsed)
                self._save_round(req, r, done=not cont)
                self._persist(req)
                if not cont:
                    self._finalize(req)

        if self.injector is not None and self.injector.kills_server(wave):
            raise ServerKilled(
                f"injected server kill after wave {wave} (journal and "
                "round checkpoints saved; restart against the same "
                "journal_dir resumes)")
        return any(r.live for r in self._requests.values())

    def run_until_idle(self, max_waves: int = ROUND_TAG_STRIDE) -> dict:
        """Pump :meth:`step` until no request is live; returns the
        service-level :meth:`status` summary."""
        waves = 0
        while self.step():
            waves += 1
            if waves >= max_waves:
                raise RuntimeError(
                    f"service did not drain within {max_waves} waves")
        return self.status()

    # ------------------------------------------------------------ internals
    def _save_round(self, req: _Request, r: int, *, done: bool) -> None:
        if req.ckpt is not None:
            req.ckpt.save_round(r, req.sm.snapshot(done=done))

    def _wave_injector(self, spans, wave: int) -> FaultInjector | None:
        """The wave's shard-boundary injector: worker-kind faults from
        the service script pass through (their ``worker_id``, when set,
        matches the *tagged* wave id ``seq * ROUND_TAG_STRIDE + wid``);
        ``slow_tenant`` faults expand into per-dispatch hangs for the
        matched tenant's shards in this wave."""
        faults = [f for f in self.cfg.faults if f["kind"] in FAULT_KINDS]
        if self.injector is not None:
            for req, r, dispatched, _lo, _hi in spans:
                delay = self.injector.slow_tenant_delay(
                    req.rec["tenant"], req.rec["id"], wave)
                if delay > 0:
                    seq = int(req.rec["seq"])
                    faults.extend(
                        {"kind": "hang",
                         "worker_id": seq * ROUND_TAG_STRIDE + wid,
                         "round": r, "attempt": 0, "hang_s": delay}
                        for wid in dispatched)
        return FaultInjector(faults=tuple(faults)) if faults else None

    def _finalize(self, req: _Request, *, partial: bool = False,
                  note: str | None = None) -> None:
        """Merge a request's absorbed rounds into its final RunResult and
        commit it. Write order is the crash-recovery contract: result
        first (the commit point), then the status flip, then cache + gc —
        a crash between any two steps is healed by :meth:`recover`."""
        sm = req.sm
        dist_info = {
            "pool_rebuilds": (self._pool.rebuilds
                              if isinstance(self._pool, ShardPool) else 0),
            "resumed_from_round": sm.resumed_from if sm else None,
            "checkpoint": None,
        }
        if req.ckpt is not None:
            dist_info["checkpoint"] = {
                "dir": req.ckpt.dir, "n_saves": req.ckpt.n_saves,
                "save_s": req.ckpt.save_s,
                "rounds_on_disk": req.ckpt.rounds()}
        try:
            res = package_dist_result(
                req.problem, req.budget, req.cfg,
                sm.results if sm else [], sm.failures if sm else [],
                dist_info,
                [s.budget.seed for s in sm.shards] if sm else [],
                float(req.rec["wall_spent_s"]), partial=partial,
                device=self.device)
        except RuntimeError as exc:       # every worker failed, not partial
            req.rec["status"] = "error"
            req.rec["error"] = str(exc)
            self._persist(req)
            return
        if note is not None:
            res = dataclasses.replace(res, extra=dict(res.extra, note=note))
        req.result = res
        if self.journal is not None:
            self.journal.save_result(int(req.rec["seq"]), res.to_json())
        req.rec["status"] = "partial" if partial else "done"
        if note is not None:
            req.rec["error"] = note
        self._persist(req)
        if self.cfg.cache and not partial:
            # Partial results are deadline/cancel artifacts — caching
            # them would serve a truncated front to a full-budget twin.
            self._cache.setdefault(req.rec["key"], res)
        if self.journal is not None:
            self.journal.gc_completed(self.cfg.keep_completed)

    def shutdown(self) -> None:
        self._stack.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.shutdown()
        return False
