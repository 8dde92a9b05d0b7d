"""Deterministic fault injection + deadline/retry dispatch in the port
(repro_torch.dist), on the CPU: the reference's contracts
(tests/test_dist_faults.py). Every degradation path of the distributed
layer is driven through :class:`repro_torch.dist.FaultInjector` —
scripted crashes, hard child aborts (a real ``BrokenProcessPool``), hangs
against per-shard deadlines, and corrupt payloads against
coordinator-side validation — and every path's failure record, retry
reseeding, and pool-rebuild accounting is pinned. The fault script itself
is held against the reference's: the same matches for the same script.
"""

import pytest

import repro.dist as ref_dist
from repro_torch.dist import (CORRUPT_PAYLOAD, FaultInjector, InjectedFault,
                              check_faults, execute_shards, retry_seed,
                              round_seed)
from repro_torch.dist.faults import (FAULT_KINDS, SERVICE_FAULT_KINDS,
                                     call_with_faults)
from repro_torch.dist.worker import ShardPool
from repro_torch.noc.optimizers import StageDistConfig


# ---------------------------------------------------------------------------
# retry_seed
# ---------------------------------------------------------------------------
def test_retry_seed_identity_and_divergence():
    # Attempt 0 is the dispatch seed itself: the no-fault path never moves.
    assert retry_seed(123, 0) == 123
    # Later attempts are fresh trajectories, distinct from each other...
    seeds = [retry_seed(123, a) for a in range(4)]
    assert len(set(seeds)) == 4
    # ...and distinct from the round-seed stream of the same base seed
    # (the tagged spawn key prevents a retry replaying a later round).
    assert retry_seed(123, 1) != round_seed(123, 1)
    assert retry_seed(123, 2) != round_seed(123, 2)
    # Deterministic in (seed, attempt).
    assert retry_seed(123, 3) == retry_seed(123, 3)
    with pytest.raises(ValueError, match="attempt"):
        retry_seed(123, -1)


# ---------------------------------------------------------------------------
# Fault script validation + matching
# ---------------------------------------------------------------------------
def test_check_faults_rejects_malformed_scripts():
    with pytest.raises(ValueError, match="kind"):
        check_faults([{"kind": "meteor"}])
    with pytest.raises(ValueError, match="round"):
        check_faults([{"kind": "crash", "round": -1}])
    with pytest.raises(ValueError, match="worker_id"):
        check_faults([{"kind": "crash", "worker_id": -2}])
    with pytest.raises(ValueError, match="hang_s"):
        check_faults([{"kind": "hang", "hang_s": -0.5}])
    with pytest.raises(ValueError, match="unknown fault keys"):
        check_faults([{"kind": "crash", "wroker_id": 1}])
    with pytest.raises(ValueError, match="dict"):
        check_faults(["crash"])
    check_faults([])  # empty script is fine
    with pytest.raises(ValueError, match="p_crash"):
        FaultInjector(p_crash=1.5)


def test_injector_matching_semantics():
    inj = FaultInjector(faults=(
        {"kind": "crash", "worker_id": 1, "round": 2, "attempt": 0},
        {"kind": "hang", "round": 1, "hang_s": 3.0},   # wildcard worker
        {"kind": "kill_coordinator", "round": 2},
    ))
    assert inj.match(1, 2, 0)["kind"] == "crash"
    assert inj.match(1, 2, 1) is None          # attempt must match exactly
    assert inj.match(0, 2, 0) is None          # other worker: clean
    assert inj.match(0, 1, 0)["kind"] == "hang"   # wildcard hits everyone
    assert inj.match(7, 1, 0)["kind"] == "hang"
    # kill_coordinator never matches a worker dispatch...
    assert inj.match(1, 2, 0)["kind"] != "kill_coordinator"
    # ...it fires at the round boundary.
    assert inj.kills_coordinator(2) and not inj.kills_coordinator(1)


def test_injector_random_mode_is_deterministic():
    inj = FaultInjector(p_crash=0.5, seed=7)
    grid = [(w, r, a) for w in range(4) for r in range(3) for a in range(2)]
    hits = [inj.match(*pos) is not None for pos in grid]
    assert hits == [FaultInjector(p_crash=0.5, seed=7).match(*pos) is not None
                    for pos in grid]          # same script, same chaos
    assert any(hits) and not all(hits)        # p=0.5 actually varies
    assert not any(FaultInjector(p_crash=0.0, seed=7).match(*p) for p in grid)


SCRIPT = (
    {"kind": "crash", "worker_id": 1, "round": 2, "attempt": 0},
    {"kind": "hang", "round": 1, "hang_s": 3.0},
    {"kind": "corrupt", "worker_id": 0, "attempt": 1},
    {"kind": "abort", "worker_id": 3},
    {"kind": "kill_coordinator", "round": 2},
    {"kind": "reject_admission", "tenant": "t0"},
    {"kind": "slow_tenant", "tenant": "t1", "wave": 2, "hang_s": 0.5},
    {"kind": "kill_server", "wave": 1},
)


@pytest.mark.parametrize("p_crash,seed", [(0.0, 0), (0.3, 7), (0.8, 11)])
def test_injector_matches_the_reference(p_crash, seed):
    assert FAULT_KINDS == ref_dist.faults.FAULT_KINDS
    assert SERVICE_FAULT_KINDS == ref_dist.SERVICE_FAULT_KINDS
    ours = FaultInjector(faults=SCRIPT, p_crash=p_crash, seed=seed)
    theirs = ref_dist.FaultInjector(faults=SCRIPT, p_crash=p_crash,
                                    seed=seed)
    for pos in [(w, r, a) for w in range(5) for r in range(4)
                for a in range(3)]:
        assert ours.match(*pos) == theirs.match(*pos), pos
    for r in range(4):
        assert ours.kills_coordinator(r) == theirs.kills_coordinator(r)
        assert ours.kills_server(r) == theirs.kills_server(r)
        for tenant in ("t0", "t1", "t2"):
            assert (ours.slow_tenant_delay(tenant, "req_000000", r)
                    == theirs.slow_tenant_delay(tenant, "req_000000", r))
    for tenant in ("t0", "t1"):
        assert (ours.rejects_admission(tenant, "r")
                == theirs.rejects_admission(tenant, "r"))


def test_abort_degrades_to_crash_in_process():
    # In the coordinator process there is no survivable hard-death; the
    # degradation is explicit in the exception text.
    inj = FaultInjector(faults=({"kind": "abort", "round": 0},))
    with pytest.raises(InjectedFault, match="degraded to crash"):
        call_with_faults(inj, 0, 0, 0, int, ("5",))


# ---------------------------------------------------------------------------
# execute_shards: in-process retry/deadline/validation paths
# ---------------------------------------------------------------------------
def _ok(x):
    return {"value": x}


def _check(payload):
    if "value" not in payload:
        raise ValueError(f"not a shard payload: {payload}")


def test_serial_crash_is_retried_with_fresh_seed():
    inj = FaultInjector(faults=(
        {"kind": "crash", "worker_id": 1, "round": 0, "attempt": 0},))
    results, failures = execute_shards(
        _ok, [("a",), ("b",)], "serial", meta=[(0, 0), (1, 0)],
        max_retries=1, injector=inj, validate=_check,
        retry_args=lambda orig, attempt: (f"{orig[0]}-retry{attempt}",))
    # Shard 1 failed attempt 0, succeeded on the reseeded attempt 1.
    assert results == {0: {"value": "a"}, 1: {"value": "b-retry1"}}
    [rec] = failures[1]
    assert (rec["worker_id"], rec["round"], rec["attempt"]) == (1, 0, 0)
    assert rec["phase"] == "run" and "injected crash" in rec["error"]
    assert "InjectedFault" in rec["traceback"]
    assert 0 not in failures


def test_serial_retries_are_bounded():
    inj = FaultInjector(p_crash=1.0)           # everything always crashes
    results, failures = execute_shards(
        _ok, [("a",)], "serial", max_retries=2, injector=inj)
    assert results == {}                       # attempts exhausted
    assert [r["attempt"] for r in failures[0]] == [0, 1, 2]
    assert all(r["phase"] == "run" for r in failures[0])


def test_serial_corrupt_payload_is_rejected_then_retried():
    inj = FaultInjector(faults=(
        {"kind": "corrupt", "round": 0, "attempt": 0},))
    results, failures = execute_shards(
        _ok, [("a",)], "serial", max_retries=1, injector=inj,
        validate=_check)
    assert results == {0: {"value": "a"}}      # retry ran clean
    [rec] = failures[0]
    assert rec["phase"] == "validate"
    assert str(CORRUPT_PAYLOAD["__corrupt__"]) in rec["error"] \
        or "not a shard payload" in rec["error"]


def test_serial_posthoc_deadline_discards_overrunning_shard():
    inj = FaultInjector(faults=(
        {"kind": "hang", "round": 0, "attempt": 0, "hang_s": 0.3},))
    results, failures = execute_shards(
        _ok, [("a",)], "serial", timeout_s=0.05, max_retries=1,
        injector=inj, validate=_check)
    assert results == {0: {"value": "a"}}      # clean retry made it
    [rec] = failures[0]
    assert rec["phase"] == "timeout" and "post-hoc" in rec["error"]


def test_failure_records_carry_traceback_not_just_message():
    """Satellite: the record has the worker's actual stack."""

    def boom(_):
        raise KeyError("the-inner-detail")

    _, failures = execute_shards(boom, [("a",)], "serial")
    [rec] = failures[0]
    assert rec["error"].startswith("KeyError")
    assert "in boom" in rec["traceback"]       # the raising frame, by name
    assert 'raise KeyError("the-inner-detail")' in rec["traceback"]


@pytest.mark.parametrize("executor", ["serial", "spmd"])
def test_inline_hang_trips_cooperative_deadline(executor):
    """The in-process executors enforce shard_timeout_s *preemptively*.

    The injected hang burns the whole deadline before the shard's search
    starts, so a post-hoc-only check (the old contract) would let the
    shard run its full budget to completion and only then discard the
    payload. The cooperative guard instead aborts at the first evaluator
    dispatch past the deadline — pinned by the distinct error text."""
    from repro_torch.core import spec_tiny
    from repro_torch.dist.worker import run_shard
    from repro_torch.noc import Budget, NocProblem

    problem = NocProblem(spec=spec_tiny(), traffic="BFS", case="case3")
    inj = FaultInjector(faults=(
        {"kind": "hang", "round": 0, "attempt": 0, "hang_s": 0.4},))
    results, failures = execute_shards(
        run_shard,
        [(problem.to_json(), Budget(max_evals=200, seed=0).to_json(), 0)],
        executor, device="cpu", timeout_s=0.2, injector=inj)
    assert results == {}
    [rec] = failures[0]
    assert rec["phase"] == "timeout"
    assert "cooperative deadline exceeded" in rec["error"]
    assert "ShardDeadlineExceeded" in rec["traceback"]


def test_deadline_guard_is_inert_without_overrun():
    """A met deadline never perturbs the run: identical payloads with
    and without a (generous) cooperative deadline armed, up to wall
    clocks (wall_s and the history timestamp column)."""
    from repro_torch.core import spec_tiny
    from repro_torch.dist.worker import run_shard
    from repro_torch.noc import Budget, NocProblem

    problem = NocProblem(spec=spec_tiny(), traffic="BFS", case="case3")
    task = [(problem.to_json(), Budget(max_evals=60, seed=2).to_json(), 2)]
    plain, f0 = execute_shards(run_shard, task, "serial", device="cpu")
    timed, f1 = execute_shards(run_shard, task, "serial", device="cpu",
                               timeout_s=600.0)
    assert f0 == {} and f1 == {}
    for res in (plain, timed):
        res[0]["wall_s"] = 0.0
        res[0]["history"] = [row[1:] for row in res[0]["history"]]
    assert plain == timed


# ---------------------------------------------------------------------------
# execute_shards: process executor — real aborts, preemptive deadlines
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_process_abort_breaks_pool_then_rebuild_and_retry_succeeds():
    inj = FaultInjector(faults=(
        {"kind": "abort", "worker_id": 0, "round": 0, "attempt": 0},))
    with ShardPool(1) as pool:
        results, failures = execute_shards(
            int, [("5",)], "process", pool=pool, meta=[(0, 0)],
            max_retries=1, injector=inj)
        assert pool.rebuilds == 1              # the abort poisoned the pool
    assert results == {0: 5}                   # clean retry on the rebuilt pool
    [rec] = failures[0]
    assert rec["phase"] == "pool" and rec["attempt"] == 0
    assert "BrokenProcessPool" in rec["error"]


@pytest.mark.slow
def test_process_hang_trips_preemptive_deadline():
    inj = FaultInjector(faults=(
        {"kind": "hang", "worker_id": 0, "round": 0, "attempt": 0,
         "hang_s": 120.0},))
    with ShardPool(2) as pool:
        # Prewarm so the deadline measures the hang, not child startup.
        warm, _ = execute_shards(int, [("1",), ("2",)], "process", pool=pool)
        assert warm == {0: 1, 1: 2}
        results, failures = execute_shards(
            int, [("5",), ("7",)], "process", pool=pool,
            meta=[(0, 0), (1, 0)], timeout_s=10.0, max_retries=1,
            injector=inj)
        assert pool.rebuilds == 1              # hung child had to be killed
    assert results[0] == 5 and results[1] == 7  # both made it eventually
    recs = failures[0]
    assert recs[0]["phase"] == "timeout" and "deadline" in recs[0]["error"]
    # Shard 1 either finished before the trip or was rebuilt collateral.
    for rec in failures.get(1, []):
        assert rec["phase"] == "pool"


# ---------------------------------------------------------------------------
# StageDistConfig knob validation (construction-time, satellite)
# ---------------------------------------------------------------------------
def test_stage_dist_config_validates_resilience_knobs():
    StageDistConfig(shard_timeout_s=5.0, max_retries=0, retry_backoff_s=1.0)
    with pytest.raises(ValueError, match="shard_timeout_s"):
        StageDistConfig(shard_timeout_s=0.0)
    with pytest.raises(ValueError, match="max_retries"):
        StageDistConfig(max_retries=-1)
    with pytest.raises(ValueError, match="retry_backoff_s"):
        StageDistConfig(retry_backoff_s=-0.1)
    with pytest.raises(ValueError, match="resume.*checkpoint_dir"):
        StageDistConfig(resume=True)
    with pytest.raises(ValueError, match="sync_every"):
        StageDistConfig(checkpoint_dir="/tmp/x", sync_every=0)
    with pytest.raises(ValueError, match="fault kind"):
        StageDistConfig(faults=({"kind": "meteor"},))
    cfg = StageDistConfig(checkpoint_dir="/tmp/x", sync_every=1,
                          faults=[{"kind": "kill_coordinator", "round": 1}])
    assert isinstance(cfg.faults, tuple)       # normalized for hashability
    with pytest.raises(ValueError, match="n_workers"):
        StageDistConfig(n_workers=0)
    with pytest.raises(ValueError, match="'cuda'"):
        StageDistConfig(executor="jax")


def test_stage_dist_config_matches_the_reference_defaults():
    """Same fields and defaults as the reference's, but for the executor
    that names a backend (the reference's ``"jax"`` is the port's
    ``"cuda"``); the default executor is ``serial`` in both."""
    from repro.noc.optimizers import StageDistConfig as RefStageDistConfig

    ours, theirs = StageDistConfig(), RefStageDistConfig()
    assert list(ours.__dataclass_fields__) == list(
        theirs.__dataclass_fields__)
    for name in ours.__dataclass_fields__:
        assert getattr(ours, name) == getattr(theirs, name), name
