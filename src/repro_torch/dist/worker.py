"""Worker side of distributed multi-start MOO-STAGE + the executor matrix.

:func:`run_shard` is a *pure function of JSON*: ``(problem_json,
budget_json, seed) -> RunResult_json``, plus the device it runs on, passed
as a string because the device is in neither the problem nor its JSON. It
rebuilds the problem, runs the registry ``stage_batch`` driver under the
shard budget, and returns the serialized result — nothing about it depends
on coordinator state, which is what lets the same function execute
in-process, in a ``ProcessPoolExecutor`` child, or on one card of several.

Executor matrix:

``serial``
    In-order, in-process loop on the run's device. The reproducibility
    anchor: the W=1 serial run is pinned byte-identical to a registry
    ``stage_batch`` run, and serial W>1 produces the same merged result as
    ``process`` and ``cuda`` (same shards, same seeds — the executor only
    chooses *where* a shard runs).
``process``
    ``concurrent.futures.ProcessPoolExecutor`` with the **spawn** start
    method, which CUDA requires (a forked child cannot use its parent's
    CUDA context). Each child opens its own CUDA context and runs its shard
    on the run's device. On a card the coordinator loads the kernel
    libraries before the pool starts (:func:`shard_pool`), so children
    only load them and never start ``nvcc``; K3's fold counter lives in
    each process's own context, so children cannot race on it.
``cuda``
    One shard per visible CUDA device, round-robin, **in order in one
    thread**, shard ``i`` on ``cuda:<i mod n>``. One thread keeps every
    device's kernels on one stream: K3 keeps its fold counter in a scratch
    per device, so two streams of one device must not run K3 at once.
    Needs a card; there is no fallback to ``serial``. The reference's
    ``"jax"`` executor is refused with a :class:`ValueError` naming this
    one.
``spmd``
    Shards run in order, but each shard's evaluator splits every batch
    into contiguous chunks across the visible CUDA devices
    (``Evaluator(split_devices=...)``), each chunk evaluated on its own
    device (K1 and K4 launched there) and the rows concatenated in order —
    data-parallel over the candidate batch instead of parallel over
    shards. Per design the evaluation is the serial one, so the rows are
    equal to ``serial``'s; the split turns the delta path off. On one card
    the split has one chunk; on the CPU (``device="cpu"``) too.

Failures are collected, not raised: :func:`execute_shards` returns
``(results, failures)`` and the coordinator merges the survivors,
reporting every failed attempt as a structured record (worker id, round,
attempt, phase, error, traceback) in ``RunResult.extra`` diagnostics.
Deadlines, bounded reseeded retries, and spawn-pool rebuilds live here
too.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import multiprocessing
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

from ..noc.api import Budget, BudgetedEvaluator, NocProblem, RunResult
from .faults import call_with_faults

EXECUTORS = ("serial", "process", "cuda", "spmd")


# --------------------------------------------------------------------------
# Cooperative in-process deadlines
# --------------------------------------------------------------------------
class ShardDeadlineExceeded(RuntimeError):
    """A shard tripped its cooperative deadline mid-search (serial/cuda/
    spmd).

    In-process executors cannot preempt their own frame the way the
    process executor's ``fut.result(timeout=...)`` + pool-kill can, so
    the deadline is enforced *cooperatively*: :func:`_execute_inline`
    arms a monotonic deadline in :data:`_DEADLINE` before dispatching,
    and the worker wraps its evaluator in :class:`_DeadlineGuard`, which
    raises this before every evaluation batch once the deadline passes.
    Every search driver funnels its evaluations through ``batch_aux`` or
    ``batch_moves``, so overrun is bounded by a single batch instead of
    the rest of the round.
    """


_DEADLINE: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "repro_torch_dist_shard_deadline", default=None)


class _DeadlineGuard(BudgetedEvaluator):
    """Evaluator proxy that trips :class:`ShardDeadlineExceeded` once the
    armed deadline passes: :class:`repro_torch.noc.api.BudgetedEvaluator`
    with the deadline as its check, so wrapping never changes a run that
    meets its deadline."""

    def __init__(self, ev, deadline: float):
        self._ev = ev
        self._deadline = deadline

    def _check(self) -> None:
        now = time.monotonic()
        if now > self._deadline:
            raise ShardDeadlineExceeded(
                f"cooperative deadline exceeded {now - self._deadline:.3f}s "
                "before an evaluation batch (in-process executors check the "
                "shard deadline between evaluator dispatches)")


def deadline_wrap(ev):
    """Wrap ``ev`` in a :class:`_DeadlineGuard` when a cooperative
    deadline is armed for this dispatch; identity otherwise."""
    deadline = _DEADLINE.get()
    return ev if deadline is None else _DeadlineGuard(ev, deadline)


def check_executor(executor: str) -> None:
    if executor == "jax":
        raise ValueError(
            "executor 'jax' names the reference's JAX backend; the port runs "
            "one shard per CUDA device with executor 'cuda'")
    if executor not in EXECUTORS:
        raise ValueError(
            f"executor must be one of {EXECUTORS}, got {executor!r}")


def cuda_devices() -> list[str]:
    """The visible CUDA devices, ``["cuda:0", ...]``; raises without one
    (the ``cuda`` executor has no fallback to the CPU)."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "executor 'cuda' runs one shard per CUDA device and none is "
            "available; use executor 'serial' with device='cpu' on the CPU")
    return [f"cuda:{i}" for i in range(n)]


def split_devices_for(device: str) -> tuple[str, ...]:
    """The devices an ``spmd`` evaluator splits its batches across: every
    visible CUDA device for a CUDA run, the CPU alone for a CPU run."""
    import torch

    return (("cpu",) if torch.device(device).type == "cpu"
            else tuple(cuda_devices()))


# --------------------------------------------------------------------------
# The pure worker functions (module-level: picklable by reference)
# --------------------------------------------------------------------------
def run_shard(problem_json: dict, budget_json: dict, seed: int,
              config_json: dict | None = None, worker_id: int = 0,
              device: str = "cuda",
              split_devices: tuple[str, ...] | None = None) -> dict:
    """Run one shard: registry ``stage_batch`` on the deserialized problem
    under the shard budget, seeded with ``seed``, on ``device`` (with
    ``split_devices``, the evaluator splits each batch across them).
    Returns the RunResult JSON with the worker id tagged into ``extra``
    (the merge orders histories by it).

    Calls :func:`repro_torch.noc.api.run` exactly as a direct registry call
    would (fresh evaluator, ctx built inside the budget guard) — a W=1
    shard at the root seed is therefore byte-identical to ``run(problem,
    "stage_batch", budget)``.
    """
    from ..noc.api import run

    problem = NocProblem.from_json(problem_json)
    budget = dataclasses.replace(Budget.from_json(budget_json),
                                 seed=int(seed))
    # The fresh evaluator api.run would have built itself — with a
    # cooperative deadline armed, behind the guard that checks it.
    ev = deadline_wrap(problem.evaluator(device=device,
                                         split_devices=split_devices))
    res = run(problem, "stage_batch", budget=budget, config=config_json,
              ev=ev)
    res.extra["worker_id"] = int(worker_id)
    return res.to_json()


def run_shard_round(problem_json: dict, budget_json: dict, seed: int,
                    config_json: dict | None = None, worker_id: int = 0,
                    starts_json: list[dict] | None = None,
                    train_x: list | None = None,
                    train_y: list | None = None,
                    global_json: dict | None = None,
                    device: str = "cuda",
                    split_devices: tuple[str, ...] | None = None) -> dict:
    """One surrogate-sync round of a shard (repro_torch.dist.sync), on
    ``device``.

    Like :func:`run_shard`, but resumes the worker's chains from
    ``starts_json``, warm-starts the surrogate from the coordinator's
    pooled ``(train_x, train_y)`` rows, and seeds the global
    non-dominated set from the pooled front ``global_json`` (designs +
    objective rows — they cost no evaluations, and make the chains
    maximize marginal PHV over what the whole fleet already found).
    Returns a composite dict::

        {"result":      RunResult JSON (this round's search),
         "x_train":     new surrogate rows this round produced,
         "y_train":     their labels,
         "next_starts": designs to resume the chains from next round}
    """
    import numpy as np

    from ..core.local_search import ParetoSet, SearchHistory
    from ..core.stage import StageBatchResult, stage_batch
    from ..noc.api import BudgetExhausted, design_from_json, design_to_json
    from ..noc.optimizers import StageBatchConfig

    problem = NocProblem.from_json(problem_json)
    budget = dataclasses.replace(Budget.from_json(budget_json),
                                 seed=int(seed))
    cfg = StageBatchConfig(**(config_json or {}))
    starts = ([design_from_json(s) for s in starts_json]
              if starts_json else None)
    train_init = None
    if train_x is not None and len(train_x):
        train_init = (np.asarray(train_x, dtype=np.float64),
                      np.asarray(train_y, dtype=np.float64))
    global_init = None
    if global_json is not None and global_json.get("designs"):
        global_init = ParetoSet(
            [design_from_json(d) for d in global_json["designs"]],
            np.asarray(global_json["objs"], dtype=np.float64))

    # The guard mirrors api.run's uniform budget enforcement: max_evals
    # duplicates stage_batch's native loop-top checks (same threshold —
    # it can only fire when the round budget is pre-spent), but max_calls
    # has no native check and must be enforced here. A guard trip forfeits
    # the round's (unfinished) search — the coordinator keeps earlier
    # rounds and flags the merged run exhausted.
    ev = problem.evaluator(device=device, split_devices=split_devices)
    guarded = BudgetedEvaluator(deadline_wrap(ev), budget)
    res: StageBatchResult | None = None
    ctx = history = None
    try:
        ctx = problem.context(guarded)  # mesh anchor: 1 guarded eval
        history = SearchHistory(ev, ctx)
        res = stage_batch(
            problem.spec, problem.traffic_matrix(), n_starts=cfg.n_starts,
            seed=budget.seed, case=problem.case, iters_max=cfg.iters_max,
            n_swaps=cfg.n_swaps, n_link_moves=cfg.n_link_moves,
            max_local_steps=cfg.max_local_steps,
            forest_kwargs=cfg.forest_kwargs,
            forest_backend=(cfg.forest_backend
                            if cfg.forest_backend is not None
                            else problem.forest_backend),
            meta_backend=cfg.meta_backend,
            max_evals=budget.max_evals, ev=guarded, ctx=ctx, history=history,
            starts=starts, train_init=train_init, global_init=global_init,
            checkpoint_restarts=True,
        )
    except BudgetExhausted:
        pass
    exhausted = res is None
    if budget.max_evals is not None and ev.n_evals >= budget.max_evals:
        exhausted = True
    if budget.max_calls is not None and ev.n_calls >= budget.max_calls:
        exhausted = True
    if res is None:
        # Guard tripped: the round's unfinished search is forfeited, but
        # any partial history records (real evaluations) are kept.
        res = StageBatchResult(
            global_set=ParetoSet.empty(), history=history, eval_errors=[],
            n_local_searches=0, n_starts=cfg.n_starts, n_evals=ev.n_evals,
            converged=False)
    rr = RunResult(
        optimizer="stage_batch",
        problem=problem.to_json(),
        budget=budget.to_json(),
        config=dataclasses.asdict(cfg),
        obj_idx=tuple(ctx.obj_idx) if ctx is not None else problem.obj_idx,
        designs=list(res.global_set.designs),
        objs=np.asarray(res.global_set.objs, dtype=np.float64),
        n_evals=ev.n_evals,
        n_calls=ev.n_calls,
        wall_s=0.0,
        history=(history.as_array() if history is not None
                 else np.zeros((0, 4))),
        extra={"worker_id": int(worker_id), "converged": res.converged,
               "n_local_searches": res.n_local_searches,
               "phv": (ctx.phv(res.global_set.objs)
                       if ctx is not None else 0.0)},
        exhausted=exhausted,
    )
    return {
        "result": rr.to_json(),
        "x_train": np.asarray(res.x_train, dtype=np.float64).tolist(),
        "y_train": np.asarray(res.y_train, dtype=np.float64).tolist(),
        "next_starts": [design_to_json(d) for d in res.next_starts],
    }


def validate_result_payload(payload) -> None:
    """Structural check on a ``run_shard`` payload (a RunResult JSON)
    before the coordinator merges it — the corrupt-payload defense for
    the no-sync path (phase ``"validate"`` on rejection)."""
    if not isinstance(payload, dict):
        raise ValueError(
            f"shard payload must be a dict, got {type(payload).__name__}")
    missing = {"designs", "objs", "n_evals", "history"} - set(payload)
    if missing:
        raise ValueError(
            f"shard payload is not a RunResult JSON; missing {sorted(missing)}")


# --------------------------------------------------------------------------
# Executors
# --------------------------------------------------------------------------
class _ShardTimeout(RuntimeError):
    """An in-process shard overran its deadline between cooperative
    checks (post-hoc backstop — see :class:`ShardDeadlineExceeded`)."""


class _ValidationFailed(RuntimeError):
    """A shard returned a payload the coordinator's validator rejected."""


def load_kernels(device: str | None) -> None:
    """On a CUDA ``device``, build (where missing) and load the NoC
    kernels' libraries in this process — what a coordinator does before it
    starts worker processes. No-op for the CPU or ``None``."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return
    from ..device import resolve_device
    from ..kernels import build

    resolve_device(device)
    build.load(build.NOC_SOURCES)


class ShardPool:
    """Rebuildable handle around a spawn ``ProcessPoolExecutor``.

    A hung or hard-died child poisons a process pool: a hang occupies a
    slot forever, an ``os._exit``/segfault marks the whole pool broken.
    Either way the only recovery is *kill the children and start over* —
    :meth:`rebuild` does exactly that (``rebuilds`` counts how often, for
    ``RunResult.extra`` diagnostics). Spawn start method throughout: CUDA
    cannot be used in a forked child, so children pay a fresh interpreter
    + import instead.
    """

    def __init__(self, n_workers: int):
        self.n_workers = max(1, int(n_workers))
        self.rebuilds = 0
        self._pool = self._make()

    def _make(self) -> ProcessPoolExecutor:
        return ProcessPoolExecutor(
            max_workers=self.n_workers,
            mp_context=multiprocessing.get_context("spawn"))

    def submit(self, fn, *args):
        return self._pool.submit(fn, *args)

    def kill(self) -> None:
        """Tear the pool down without waiting on its children — the only
        way out when one of them is hung."""
        procs = list((getattr(self._pool, "_processes", None) or {}).values())
        self._pool.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            try:
                p.terminate()
            except (OSError, ValueError):
                pass
        for p in procs:
            try:
                p.join(timeout=5.0)
            except (OSError, ValueError, AssertionError):
                pass

    def rebuild(self) -> None:
        self.kill()
        self._pool = self._make()
        self.rebuilds += 1

    def shutdown(self) -> None:
        try:
            self._pool.shutdown(wait=True, cancel_futures=True)
        except Exception:  # noqa: BLE001 — a broken pool may refuse politely
            self.kill()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.shutdown()
        return False


@contextlib.contextmanager
def shard_pool(executor: str, n_workers: int, device: str | None = None):
    """Reusable process pool for multi-round dispatch (repro_torch.dist.
    sync): spawn-started children pay interpreter + torch import once, not
    once per round. Yields a :class:`ShardPool` for ``process``, None for
    the in-process executors. On a CUDA ``device`` the kernel libraries are
    loaded here first (:func:`load_kernels`)."""
    check_executor(executor)
    if executor != "process":
        yield None
        return
    load_kernels(device)
    with ShardPool(n_workers) as pool:
        yield pool


def _failure_record(worker_id: int, round_idx: int, attempt: int,
                    phase: str, exc) -> dict:
    """Structured failure record. ``phase`` is where the dispatch died:
    ``"run"`` (worker raised), ``"timeout"`` (deadline), ``"pool"``
    (process pool broke — culprit unattributable), or ``"validate"``
    (payload rejected by the coordinator)."""
    if isinstance(exc, BaseException):
        error = f"{type(exc).__name__}: {exc}"
        cause = getattr(exc, "__cause__", None)
        if cause is not None and type(cause).__name__ == "_RemoteTraceback":
            tb = str(cause)  # the child's stack, smuggled across the pickle
        else:
            tb = "".join(traceback.format_exception(exc))
    else:
        error = str(exc)
        tb = ""
    return {"worker_id": int(worker_id), "round": int(round_idx),
            "attempt": int(attempt), "phase": str(phase),
            "error": error, "traceback": tb}


def _record_failure(failures: dict, idx: int, rec: dict) -> None:
    failures.setdefault(idx, []).append(rec)


def _run_validated(payload, validate):
    if validate is not None:
        try:
            validate(payload)
        except Exception as exc:  # noqa: BLE001 — any rejection counts
            raise _ValidationFailed(str(exc)) from exc
    return payload


def execute_shards(fn, arg_tuples: list[tuple], executor: str = "serial",
                   pool=None, *, device: str | None = None,
                   meta: list[tuple[int, int]] | None = None,
                   timeout_s: float | None = None, max_retries: int = 0,
                   backoff_s: float = 0.0, retry_args=None, injector=None,
                   validate=None) -> tuple[dict[int, dict],
                                           dict[int, list[dict]]]:
    """Run ``fn(*args)`` for every entry of ``arg_tuples`` under the
    chosen executor, with per-shard deadlines and bounded retries.

    Entry ``i`` is shard ``i``; returns ``(results, failures)`` keyed by
    shard index. Every failed *attempt* appends a structured record (see
    :func:`_failure_record`) to ``failures[i]`` — so an index present in
    both maps means "succeeded after retries", and an index only in
    ``failures`` is a shard that exhausted its attempts (the coordinator
    merges the survivors; fault isolation, not abort).

    Knobs (all keyword-only):

    ``device``
        The device the shards run on, passed to ``fn`` as ``device=``
        (``None``: ``fn`` is called as it is, on its own default). The
        ``cuda`` executor passes shard ``i`` ``device="cuda:<i mod n>"``
        instead and refuses a CPU ``device``; ``spmd`` also passes
        ``split_devices=`` (see :func:`split_devices_for`).
    ``meta``
        ``(worker_id, round_idx)`` per shard, for failure records and
        fault matching. Defaults to ``(i, 0)``.
    ``timeout_s``
        Per-shard wall-clock deadline. Under ``process`` it is enforced
        *preemptively* — ``fut.result(timeout=...)`` measured from wave
        dispatch, and a trip kills + rebuilds the pool (the hung child
        holds a slot; there is no gentler eviction). The in-process
        executors cannot preempt their own frame, so they enforce the
        deadline *cooperatively*: the armed :data:`_DEADLINE` makes the
        worker's evaluator raise :class:`ShardDeadlineExceeded` before the
        first evaluation batch past the deadline — overrun is bounded by
        one batch, not the rest of the shard — with a post-hoc elapsed
        check as backstop for overruns between evaluator dispatches.
        Either trip is charged as a ``"timeout"`` failure.
    ``max_retries`` / ``backoff_s``
        Up to ``max_retries`` re-dispatches per shard, sleeping
        ``backoff_s * 2**(attempt-1)`` before attempt ``attempt``.
    ``retry_args``
        ``(orig_args, attempt) -> new_args`` — re-derives the dispatch
        for attempt ``attempt`` (the coordinator reseeds via
        :func:`repro_torch.dist.plan.retry_seed`, so a retry samples a
        fresh trajectory instead of replaying the crash). Default: retry
        the identical args.
    ``injector``
        :class:`repro_torch.dist.faults.FaultInjector` wrapped around the
        worker boundary via ``call_with_faults`` (inside the child for
        ``process``, so aborts/hangs are physically real).
    ``validate``
        Coordinator-side payload check; a raise becomes a ``"validate"``
        failure (retriable — this is the corrupt-payload defense).

    ``pool`` (a :class:`ShardPool` from :func:`shard_pool`) reuses one
    process pool across calls; without it the ``process`` executor
    builds a one-shot pool. On pool breakage every in-flight shard is
    charged a ``"pool"`` failure (the culprit is unattributable) and
    re-dispatched against the rebuilt pool if it has attempts left.
    """
    check_executor(executor)
    if meta is None:
        meta = [(i, 0) for i in range(len(arg_tuples))]
    if max_retries < 0:
        raise ValueError(f"max_retries must be >= 0, got {max_retries}")

    if executor == "process":
        if device is not None:
            fn = functools.partial(fn, device=device)
        return _execute_process(fn, arg_tuples, pool, meta, timeout_s,
                                max_retries, backoff_s, retry_args,
                                injector, validate, device)
    if executor == "cuda":
        import torch

        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"executor 'cuda' runs shards on CUDA devices, "
                             f"got device {device!r}")
        devices = cuda_devices()
        fns = [functools.partial(fn, device=devices[i % len(devices)])
               for i in range(len(arg_tuples))]
    elif executor == "spmd":
        dev = "cuda" if device is None else device
        fns = [functools.partial(fn, device=dev,
                                 split_devices=split_devices_for(dev))
               ] * len(arg_tuples)
    else:
        fns = [fn if device is None else functools.partial(fn, device=device)
               ] * len(arg_tuples)
    return _execute_inline(fns, arg_tuples, meta, timeout_s, max_retries,
                           backoff_s, retry_args, injector, validate)


def _execute_inline(fns, arg_tuples, meta, timeout_s, max_retries,
                    backoff_s, retry_args, injector, validate):
    """serial/cuda/spmd: in-process, in-order dispatch with an inline retry
    loop; ``fns[i]`` is shard ``i``'s function with its device bound."""
    results: dict[int, dict] = {}
    failures: dict[int, list[dict]] = {}
    for i, orig_args in enumerate(arg_tuples):
        wid, rnd = meta[i]
        args = orig_args
        for attempt in range(max_retries + 1):
            if attempt > 0:
                if backoff_s > 0:
                    time.sleep(backoff_s * (2 ** (attempt - 1)))
                if retry_args is not None:
                    args = retry_args(orig_args, attempt)
            t0 = time.monotonic()
            token = (_DEADLINE.set(t0 + timeout_s)
                     if timeout_s is not None else None)
            try:
                payload = call_with_faults(
                    injector, wid, rnd, attempt, fns[i], args)
                elapsed = time.monotonic() - t0
                if timeout_s is not None and elapsed > timeout_s:
                    # Backstop for shards that overran between evaluator
                    # dispatches (e.g. the final surrogate refit): the
                    # cooperative guard can only fire at an evaluation.
                    raise _ShardTimeout(
                        f"shard ran {elapsed:.3f}s, deadline {timeout_s}s "
                        "(post-hoc backstop: the overrun fell between "
                        "cooperative deadline checks)")
                results[i] = _run_validated(payload, validate)
                break
            except Exception as exc:  # noqa: BLE001 — fault isolation
                phase = ("timeout" if isinstance(
                             exc, (_ShardTimeout, ShardDeadlineExceeded))
                         else "validate" if isinstance(exc, _ValidationFailed)
                         else "run")
                _record_failure(failures, i,
                                _failure_record(wid, rnd, attempt, phase, exc))
            finally:
                if token is not None:
                    _DEADLINE.reset(token)
    return results, failures


def _execute_process(fn, arg_tuples, pool, meta, timeout_s, max_retries,
                     backoff_s, retry_args, injector, validate, device):
    """process: wave dispatch with preemptive deadlines + pool rebuild."""
    from concurrent.futures import TimeoutError as FutTimeout
    from concurrent.futures.process import BrokenProcessPool

    results: dict[int, dict] = {}
    failures: dict[int, list[dict]] = {}
    own_pool = pool is None
    if own_pool:
        load_kernels(device)
        pool = ShardPool(len(arg_tuples))
    try:
        wave = [(i, 0, arg_tuples[i]) for i in range(len(arg_tuples))]
        while wave:
            delay = max((backoff_s * (2 ** (a - 1))
                         for _, a, _ in wave if a > 0), default=0.0)
            if delay > 0:
                time.sleep(delay)
            t0 = time.monotonic()
            futs = []
            for i, attempt, args in wave:
                wid, rnd = meta[i]
                futs.append((i, attempt, args, pool.submit(
                    call_with_faults, injector, wid, rnd, attempt, fn, args)))
            next_wave = []

            def _retry(i, attempt, args):
                if attempt < max_retries:
                    new_args = (retry_args(arg_tuples[i], attempt + 1)
                                if retry_args is not None else args)
                    next_wave.append((i, attempt + 1, new_args))

            disrupted = None  # reason string once the pool must be rebuilt
            for i, attempt, args, fut in futs:
                wid, rnd = meta[i]
                if disrupted is not None and not fut.done():
                    # Collateral of the rebuild-to-come: this shard was
                    # in flight when the pool got poisoned.
                    _record_failure(failures, i, _failure_record(
                        wid, rnd, attempt, "pool", disrupted))
                    _retry(i, attempt, args)
                    continue
                try:
                    if timeout_s is None:
                        payload = fut.result()
                    else:
                        remaining = t0 + timeout_s - time.monotonic()
                        payload = fut.result(timeout=max(0.0, remaining))
                    results[i] = _run_validated(payload, validate)
                except FutTimeout:
                    exc = _ShardTimeout(
                        f"shard exceeded its {timeout_s}s deadline; pool "
                        "killed and rebuilt")
                    _record_failure(failures, i, _failure_record(
                        wid, rnd, attempt, "timeout", exc))
                    _retry(i, attempt, args)
                    disrupted = (f"pool rebuilt after worker {wid} tripped "
                                 f"its {timeout_s}s deadline")
                except BrokenProcessPool as exc:
                    _record_failure(failures, i, _failure_record(
                        wid, rnd, attempt, "pool", exc))
                    _retry(i, attempt, args)
                    disrupted = f"{type(exc).__name__}: {exc}"
                except _ValidationFailed as exc:
                    _record_failure(failures, i, _failure_record(
                        wid, rnd, attempt, "validate", exc))
                    _retry(i, attempt, args)
                except Exception as exc:  # noqa: BLE001 — fault isolation
                    _record_failure(failures, i, _failure_record(
                        wid, rnd, attempt, "run", exc))
                    _retry(i, attempt, args)
            if disrupted is not None:
                pool.rebuild()
            wave = next_wave
    finally:
        if own_pool:
            pool.shutdown()
    return results, failures
