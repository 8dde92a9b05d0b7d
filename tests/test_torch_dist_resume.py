"""Crash-safe round checkpoints + interrupt/resume determinism in the
port (repro_torch.dist), on the CPU: the reference's contracts
(tests/test_dist_resume.py).

The contract under test: a synced ``stage_dist`` run with
``checkpoint_dir`` set persists its complete coordinator state after
every round; killing the coordinator mid-run (via the deterministic
``kill_coordinator`` fault) and resuming with ``resume=True`` produces a
merged RunResult whose canonical payload is byte-identical to the
uninterrupted run's. Plus the chaos acceptance pin: a W=4 run surviving
a hung shard, a crashing worker, and a coordinator kill still completes
within budget, reports every failure, and merges a union front no worse
than any survivor's.
"""

import json
import math

import numpy as np
import pytest

from repro_torch.core import spec_tiny
from repro_torch.dist import CoordinatorKilled
from repro_torch.dist.sync import ROUND_TAG_STRIDE
from repro_torch.noc import Budget, NocProblem, RunResult
from repro_torch.noc import run as _run

SMALL = dict(iters_max=2, n_swaps=4, n_link_moves=4, max_local_steps=5)


def run(*args, **kwargs):
    """``repro_torch.noc.run`` on the CPU."""
    return _run(*args, device="cpu", **kwargs)


@pytest.fixture(scope="module")
def tiny_problem() -> NocProblem:
    return NocProblem(spec=spec_tiny(), traffic="BFS", case="case3")


def _payload(res: RunResult) -> str:
    """Canonical payload JSON (same canon as test_dist.py): wall-clock
    zeroed; driver-naming header fields (optimizer/config/extra)
    excluded — config legitimately differs (faults/checkpoint knobs)."""
    j = res.to_json()
    j["history"] = [[0.0] + row[1:] for row in j["history"]]
    keep = ("problem", "budget", "obj_idx", "designs", "objs", "history",
            "n_evals", "n_calls", "exhausted")
    return json.dumps({k: j[k] for k in keep}, sort_keys=True)


def _interrupt_then_resume(problem, budget, cfg, kill_round, ckpt_dir,
                           resume_cfg=None):
    """Run with a scripted coordinator kill after ``kill_round``, then
    resume from the checkpoint; returns the resumed RunResult."""
    with pytest.raises(CoordinatorKilled, match="checkpoint saved"):
        run(problem, "stage_dist", budget=budget,
            config=dict(cfg, faults=(
                {"kind": "kill_coordinator", "round": kill_round},)),
            checkpoint_dir=ckpt_dir)
    return run(problem, "stage_dist", budget=budget,
               config=dict(resume_cfg if resume_cfg is not None else cfg),
               checkpoint_dir=ckpt_dir, resume=True)


# ---------------------------------------------------------------------------
# Interrupt/resume byte-identity (the tentpole's core pin)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("executor", ["serial", "spmd"])
@pytest.mark.parametrize("kill_round", [0, 1])
def test_serial_resume_is_byte_identical(tiny_problem, tmp_path, kill_round,
                                         executor):
    budget = Budget(max_evals=300, seed=1)
    cfg = dict(SMALL, n_workers=2, executor=executor, sync_every=1,
               iters_max=3)
    ref = run(tiny_problem, "stage_dist", budget=budget, config=cfg)
    res = _interrupt_then_resume(tiny_problem, budget, cfg, kill_round,
                                 str(tmp_path / f"ck{kill_round}"))
    assert _payload(res) == _payload(ref)
    assert res.extra["history_spans"] == ref.extra["history_spans"]
    assert res.extra["resumed_from_round"] == kill_round
    ck = res.extra["checkpoint"]
    assert ck["n_saves"] >= 1 and ck["save_s"] >= 0.0


@pytest.mark.slow
def test_process_resume_is_byte_identical(tiny_problem, tmp_path):
    budget = Budget(max_evals=300, seed=1)
    cfg = dict(SMALL, n_workers=2, executor="process", sync_every=1,
               iters_max=3)
    ref = run(tiny_problem, "stage_dist", budget=budget, config=cfg)
    res = _interrupt_then_resume(tiny_problem, budget, cfg, 1,
                                 str(tmp_path / "ck"))
    assert _payload(res) == _payload(ref)
    # Executor is NOT part of the run identity: a serial resume of a
    # process-interrupted run continues the same trajectory.
    res2 = _interrupt_then_resume(
        tiny_problem, budget, cfg, 1, str(tmp_path / "ck2"),
        resume_cfg=dict(cfg, executor="serial"))
    assert _payload(res2) == _payload(ref)


def test_resume_refuses_mismatched_run(tiny_problem, tmp_path):
    budget = Budget(max_evals=200, seed=3)
    cfg = dict(SMALL, n_workers=2, executor="serial", sync_every=1)
    run(tiny_problem, "stage_dist", budget=budget, config=cfg,
        checkpoint_dir=str(tmp_path))
    # Different seed => different run identity: refuse, don't merge.
    with pytest.raises(ValueError, match="different run"):
        run(tiny_problem, "stage_dist", budget=Budget(max_evals=200, seed=4),
            config=cfg, checkpoint_dir=str(tmp_path), resume=True)
    # Different trajectory config (n_workers) is a different run too.
    with pytest.raises(ValueError, match="different run"):
        run(tiny_problem, "stage_dist", budget=budget,
            config=dict(cfg, n_workers=3),
            checkpoint_dir=str(tmp_path), resume=True)


def test_resume_of_completed_run_is_a_noop_replay(tiny_problem, tmp_path):
    """Resuming a checkpoint whose run already finished must return the
    finished state unchanged — not dispatch extra rounds the
    uninterrupted run would never have run."""
    budget = Budget(max_evals=200, seed=5)
    cfg = dict(SMALL, n_workers=2, executor="serial", sync_every=1)
    ref = run(tiny_problem, "stage_dist", budget=budget, config=cfg,
              checkpoint_dir=str(tmp_path))
    res = run(tiny_problem, "stage_dist", budget=budget, config=cfg,
              checkpoint_dir=str(tmp_path), resume=True)
    assert _payload(res) == _payload(ref)


def test_checkpoint_requires_sync_rounds(tiny_problem):
    with pytest.raises(ValueError, match="sync_every"):
        run(tiny_problem, "stage_dist", budget=Budget(max_evals=50),
            config=dict(SMALL, n_workers=2, sync_every=0),
            checkpoint_dir="/tmp/nope")
    # Non-coordinator optimizers have no round checkpoints at all.
    with pytest.raises(ValueError, match="does not support"):
        run(tiny_problem, "stage", budget=Budget(max_evals=50),
            checkpoint_dir="/tmp/nope")
    with pytest.raises(ValueError, match="resume=True requires"):
        run(tiny_problem, "stage_dist", budget=Budget(max_evals=50),
            config=dict(SMALL, n_workers=2, sync_every=1), resume=True)


def test_no_fault_path_unchanged_by_checkpointing(tiny_problem, tmp_path):
    """Observability must not perturb the search: the checkpointed run's
    payload equals the plain run's (PR 5 determinism pins intact)."""
    budget = Budget(max_evals=250, seed=2)
    cfg = dict(SMALL, n_workers=2, executor="serial", sync_every=1)
    plain = run(tiny_problem, "stage_dist", budget=budget, config=cfg)
    ckpt = run(tiny_problem, "stage_dist", budget=budget, config=cfg,
               checkpoint_dir=str(tmp_path))
    assert _payload(ckpt) == _payload(plain)
    assert plain.extra["worker_failures"] == []
    assert plain.extra["pool_rebuilds"] == 0


# ---------------------------------------------------------------------------
# Chaos acceptance pin (ISSUE: 1 hang + 1 crash + 1 coordinator kill, W=4)
# ---------------------------------------------------------------------------
def test_chaos_run_survives_and_reports_everything(tiny_problem, tmp_path):
    budget = Budget(max_evals=400, seed=9)
    # The deadline must sit between a legitimate shard round's wall time
    # (sub-second to a few seconds on a loaded machine) and the injected
    # hang — generous on both sides so the only deadline trip is the
    # scripted one.
    cfg = dict(SMALL, n_workers=4, executor="serial", sync_every=1,
               iters_max=3, shard_timeout_s=8.0, max_retries=1)
    faults = (
        # Worker 2 hangs past the deadline on round 0 attempt 0; its
        # reseeded retry runs clean.
        {"kind": "hang", "worker_id": 2, "round": 0, "attempt": 0,
         "hang_s": 8.5},
        # Worker 1 crashes BOTH attempts of round 1: retries exhausted,
        # dropped from later rounds.
        {"kind": "crash", "worker_id": 1, "round": 1, "attempt": 0},
        {"kind": "crash", "worker_id": 1, "round": 1, "attempt": 1},
        # And the coordinator dies after round 1's checkpoint.
        {"kind": "kill_coordinator", "round": 1},
    )
    with pytest.raises(CoordinatorKilled):
        run(tiny_problem, "stage_dist", budget=budget,
            config=dict(cfg, faults=faults), checkpoint_dir=str(tmp_path))
    res = run(tiny_problem, "stage_dist", budget=budget, config=cfg,
              checkpoint_dir=str(tmp_path), resume=True)

    # Completed within the global eval budget (+ the documented per-worker
    # in-flight overshoot; lost attempts are unaccounted by design).
    per_worker = 2 * (SMALL["n_swaps"] + SMALL["n_link_moves"]) + 2
    assert res.n_evals <= 400 + 4 * per_worker
    assert res.extra["resumed_from_round"] == 1

    # Every injected degradation shows up in the failure ledger.
    fails = res.extra["worker_failures"]
    assert [(f["worker_id"], f["round"], f["attempt"], f["phase"])
            for f in fails] == [
        (2, 0, 0, "timeout"),       # the hang, caught post-hoc
        (1, 1, 0, "run"),           # the crash...
        (1, 1, 1, "run"),           # ...and its doomed retry
    ]
    assert all(f["traceback"] or f["phase"] == "timeout" for f in fails)

    # Worker 1's round-0 span survives; nothing of its round 2 exists.
    span_tags = [w for w, _, _ in res.extra["history_spans"]]
    assert (1 * ROUND_TAG_STRIDE + 0) in span_tags
    assert (1 * ROUND_TAG_STRIDE + 2) not in span_tags

    # The merged front is the union of the survivors: its PHV is never
    # worse than any single surviving worker's own.
    worker_phvs = [w["phv"] for w in res.extra["workers"]
                   if not math.isnan(w["phv"])]
    assert worker_phvs and res.phv() >= max(worker_phvs) - 1e-12
    assert len(res.designs) >= 1 and np.isfinite(res.phv())


def test_resume_of_a_reference_checkpoint(tiny_problem, tmp_path):
    """The round checkpoints are the reference's files: the port resumes
    a run the reference's coordinator checkpointed (the state is JSON of
    the shared schema; the rounds after the kill are the port's)."""
    import repro.noc as ref_noc
    from repro.dist import CoordinatorKilled as RefCoordinatorKilled

    budget = Budget(max_evals=200, seed=3)
    cfg = dict(SMALL, n_workers=2, executor="serial", sync_every=1)
    ref_problem = ref_noc.NocProblem(spec=ref_noc.named_spec("tiny"),
                                     traffic="BFS", case="case3")
    with pytest.raises(RefCoordinatorKilled):
        ref_noc.run(ref_problem, "stage_dist",
                    budget=ref_noc.Budget(max_evals=200, seed=3),
                    config=dict(cfg, faults=(
                        {"kind": "kill_coordinator", "round": 0},)),
                    checkpoint_dir=str(tmp_path))
    res = run(tiny_problem, "stage_dist", budget=budget, config=cfg,
              checkpoint_dir=str(tmp_path), resume=True)
    assert res.extra["resumed_from_round"] == 0
    assert len(res.designs) >= 1 and np.isfinite(res.phv())
    # A different run refuses the reference's checkpoint, as it refuses
    # its own.
    with pytest.raises(ValueError, match="different run"):
        run(tiny_problem, "stage_dist", budget=Budget(max_evals=200, seed=4),
            config=cfg, checkpoint_dir=str(tmp_path), resume=True)
