"""Distributed multi-start MOO-STAGE in the port (repro_torch.dist) on the
CPU: the reference's merge/determinism/fault-injection contracts
(tests/test_dist.py), the executor matrix of the port, and the port held
against the reference — the same plan integers, the same merged JSON from
the reference's own worker results, and the same W=3 run (worker by
worker: the same front, or a knife-edge whose replay on the reference's
rows is the reference's run bit for bit, ``noc.parity``).
"""

import itertools
import json

import numpy as np
import pytest
import torch

import repro.dist as ref_dist
import repro.noc as ref_noc
from repro.dist import worker as ref_worker
from repro_torch.core import dominates, spec_tiny
from repro_torch.dist import (merge_results, n_rounds, plan_shards,
                              retry_seed, round_seed, spawn_seeds,
                              split_evenly)
from repro_torch.dist import worker as dist_worker
from repro_torch.noc import Budget, NocProblem, RunResult, named_spec, run
from repro_torch.noc.parity import hold_runs

#: few-second stage_batch knobs shared by the whole suite
SMALL = dict(iters_max=2, n_swaps=4, n_link_moves=4, max_local_steps=5)
#: 8 f32 ulps, relative: the parity bar of the port against the reference.
ULPS8 = 8 * 2.0 ** -24


@pytest.fixture(scope="module")
def tiny_problem() -> NocProblem:
    return NocProblem(spec=spec_tiny(), traffic="BFS", case="case3")


@pytest.fixture(scope="module")
def worker_results(tiny_problem) -> list[RunResult]:
    """Three REAL worker RunResults — one per shard of a W=3 plan —
    exactly what the coordinator's merge consumes."""
    shards = plan_shards(tiny_problem, Budget(max_evals=360, seed=7), 3)
    out = []
    for s in shards:
        raw = dist_worker.run_shard(s.problem.to_json(), s.budget.to_json(),
                                    s.budget.seed, dict(SMALL, n_starts=1),
                                    worker_id=s.worker_id, device="cpu")
        out.append(RunResult.from_json(raw))
    return out


def _payload(res) -> str:
    """Canonical payload JSON: wall-clock zeroed; header fields that
    necessarily name the driver (optimizer/config/extra) excluded."""
    j = res.to_json()
    j["history"] = [[0.0] + row[1:] for row in j["history"]]
    keep = ("problem", "budget", "obj_idx", "designs", "objs", "history",
            "n_evals", "n_calls", "exhausted")
    return json.dumps({k: j[k] for k in keep}, sort_keys=True)


def _pareto_sig(res) -> tuple:
    """(design keys, objective bytes) — the merge-invariant Pareto part."""
    return (tuple(d.key() for d in res.designs),
            np.asarray(res.objs, dtype=np.float64).tobytes())


def _dist(problem, budget, **cfg):
    return run(problem, "stage_dist", budget=budget, config=cfg,
               device="cpu")


# ---------------------------------------------------------------------------
# Shard planning
# ---------------------------------------------------------------------------
def test_split_evenly_remainder_exact():
    for total, k in ((10, 3), (7, 7), (5, 8), (0, 4), (1000, 7)):
        parts = split_evenly(total, k)
        assert sum(parts) == total and len(parts) == k
        assert max(parts) - min(parts) <= 1
    assert split_evenly(None, 3) == [None, None, None]
    with pytest.raises(ValueError, match="k must be"):
        split_evenly(10, 0)
    with pytest.raises(ValueError, match="total must be"):
        split_evenly(-1, 2)


def test_spawn_seeds_identity_and_determinism():
    # W=1 passes the root seed through — the serial-equivalence anchor.
    assert spawn_seeds(3, 1) == [3]
    s1 = spawn_seeds(3, 4)
    assert s1 == spawn_seeds(3, 4)            # deterministic in the root
    assert len(set(s1)) == 4                  # distinct streams
    assert s1 != spawn_seeds(4, 4)            # root seed matters
    with pytest.raises(ValueError, match="n_workers"):
        spawn_seeds(0, 0)


def test_plan_shards_budget_sums(tiny_problem):
    for w, me, mc in ((4, 1000, None), (3, 100, 17), (5, 3, 3)):
        shards = plan_shards(tiny_problem, Budget(max_evals=me, max_calls=mc,
                                                  seed=5), w)
        assert [s.worker_id for s in shards] == list(range(w))
        assert sum(s.budget.max_evals for s in shards) == me
        if mc is None:
            assert all(s.budget.max_calls is None for s in shards)
        else:
            assert sum(s.budget.max_calls for s in shards) == mc
        assert [s.budget.seed for s in shards] == spawn_seeds(5, w)
        assert all(s.problem is tiny_problem for s in shards)
    ident = plan_shards(tiny_problem, Budget(max_evals=50, seed=9), 1)[0]
    assert ident.budget == Budget(max_evals=50, seed=9)


def test_n_rounds():
    assert n_rounds(12, 5) == 3 and n_rounds(12, 12) == 1
    assert n_rounds(12, 100) == 1
    with pytest.raises(ValueError, match="sync_every"):
        n_rounds(12, 0)


@pytest.mark.parametrize("root", [0, 1, 7, 2 ** 31 - 1, 123456789])
def test_plan_integers_equal_the_reference(tiny_problem, root):
    ref_problem = ref_noc.NocProblem(spec=ref_noc.named_spec("tiny"),
                                     traffic="BFS", case="case3")
    for w in (1, 2, 3, 4, 7):
        assert spawn_seeds(root, w) == ref_dist.spawn_seeds(root, w)
        for total in (None, 0, 5, 2000, 2001):
            assert split_evenly(total, w) == ref_dist.split_evenly(total, w)
        ours = plan_shards(tiny_problem, Budget(max_evals=2000, max_calls=97,
                                                seed=root), w)
        theirs = ref_dist.plan_shards(
            ref_problem, ref_noc.Budget(max_evals=2000, max_calls=97,
                                        seed=root), w)
        assert [s.to_json() for s in ours] == [s.to_json() for s in theirs]
    for r in range(4):
        assert round_seed(root, r) == ref_dist.round_seed(root, r)
    for a in range(4):
        assert retry_seed(root, a) == ref_dist.retry_seed(root, a)


# ---------------------------------------------------------------------------
# Merge semantics
# ---------------------------------------------------------------------------
def test_merge_commutative_bit_identical_under_any_order(worker_results):
    """Merged Pareto objectives (and designs, history, and accounting) are
    bit-identical under ANY permutation of worker result arrival order."""
    ref = merge_results(list(worker_results))
    ref_payload = _payload(ref)
    ref_spans = ref.extra["history_spans"]
    for perm in itertools.permutations(worker_results):
        m = merge_results(list(perm))
        assert _pareto_sig(m) == _pareto_sig(ref)
        assert _payload(m) == ref_payload
        assert m.extra["history_spans"] == ref_spans


def test_merge_associative(worker_results):
    a, b, c = worker_results
    flat = merge_results([a, b, c])
    left = merge_results([merge_results([a, b]), c])
    right = merge_results([a, merge_results([b, c])])
    assert _payload(left) == _payload(flat) == _payload(right)
    assert _pareto_sig(left) == _pareto_sig(flat) == _pareto_sig(right)
    # Nested merges flatten their history spans to the same tagging.
    assert (left.extra["history_spans"] == flat.extra["history_spans"]
            == right.extra["history_spans"])


def test_merge_idempotent(worker_results):
    a = worker_results[0]
    # Singleton merge is the identity (payload AND headers).
    solo = merge_results([a])
    assert _payload(solo) == _payload(a)
    assert solo.extra == a.extra
    # Merging a result with a copy of itself (re-tagged: ids must be
    # unique) adds nothing to the Pareto union. Compared as SETS: the
    # singleton merge passes the worker's front through in insertion
    # order, while a >=2-input merge canonical-sorts.
    twin = RunResult.from_json(a.to_json())
    twin.extra["worker_id"] = 99
    both = merge_results([a, twin])

    def _rows(res):
        objs = np.asarray(res.objs, np.float64)
        return sorted((d.key(), objs[i].tobytes())
                      for i, d in enumerate(res.designs))

    assert _rows(both) == _rows(merge_results([a]))
    # A merge of a merge changes nothing.
    m = merge_results(list(worker_results))
    assert _payload(merge_results([m])) == _payload(m)


def test_merge_accounting_is_sum_of_shards(worker_results):
    m = merge_results(list(worker_results))
    assert m.n_evals == sum(r.n_evals for r in worker_results)
    assert m.n_calls == sum(r.n_calls for r in worker_results)
    assert m.wall_s == max(r.wall_s for r in worker_results)
    assert m.exhausted == any(r.exhausted for r in worker_results)
    total_rows = sum(np.asarray(r.history).shape[0] for r in worker_results)
    assert np.asarray(m.history).shape == (total_rows, 4)
    # Spans partition the merged history, in worker-id order, one per input.
    spans = m.extra["history_spans"]
    assert [w for w, _, _ in spans] == [0, 1, 2]
    assert spans[0][1] == 0 and spans[-1][2] == total_rows
    for (w1, a1, b1), (w2, a2, b2) in zip(spans, spans[1:]):
        assert b1 == a2
    for (w, a, b), r in zip(spans, worker_results):
        np.testing.assert_array_equal(m.history[a:b], r.history)


def test_merge_result_is_mutually_nondominated(worker_results):
    m = merge_results(list(worker_results))
    assert len(m.designs) >= 1
    sub = np.asarray(m.objs)[:, list(m.obj_idx)]
    for i in range(sub.shape[0]):
        for j in range(sub.shape[0]):
            if i != j:
                assert not dominates(sub[i], sub[j])
    all_keys = {d.key() for r in worker_results for d in r.designs}
    assert {d.key() for d in m.designs} <= all_keys


def test_merged_runresult_json_roundtrip_exact(worker_results, tmp_path):
    m = merge_results(list(worker_results))
    path = tmp_path / "merged.json"
    m.save(path)
    back = RunResult.load(path)
    assert _payload(back) == _payload(m)
    assert np.array_equal(np.asarray(back.objs), np.asarray(m.objs))
    assert [d.key() for d in back.designs] == [d.key() for d in m.designs]
    assert np.array_equal(back.history, m.history, equal_nan=True)
    assert back.extra["history_spans"] == m.extra["history_spans"]
    assert json.dumps(back.to_json()) == json.dumps(m.to_json())


def test_merge_input_validation(worker_results):
    a, b = worker_results[:2]
    with pytest.raises(ValueError, match="at least one"):
        merge_results([])
    bad = RunResult.from_json(a.to_json())
    bad.obj_idx = (0, 1)
    with pytest.raises(ValueError, match="objective subsets"):
        merge_results([b, bad])
    dup = RunResult.from_json(b.to_json())  # same worker_id as b
    with pytest.raises(ValueError, match="unique"):
        merge_results([b, dup])


@pytest.mark.parametrize("seed", [7, 8])
def test_merge_of_reference_worker_results_is_the_reference_merge(seed):
    """The reference's own worker RunResult JSON, merged by the port, gives
    the reference's merged JSON — with and without a PHV context."""
    ref_problem = ref_noc.NocProblem(spec=ref_noc.named_spec("tiny"),
                                     traffic="BFS", case="case3")
    shards = ref_dist.plan_shards(ref_problem,
                                  ref_noc.Budget(max_evals=240, seed=seed), 3)
    raw = [ref_worker.run_shard(s.problem.to_json(), s.budget.to_json(),
                                s.budget.seed, dict(SMALL, n_starts=1),
                                worker_id=s.worker_id) for s in shards]
    theirs = ref_dist.merge_results(
        [ref_noc.RunResult.from_json(r) for r in raw])
    ours = merge_results([RunResult.from_json(r) for r in raw])
    assert json.dumps(ours.to_json()) == json.dumps(theirs.to_json())
    # Any arrival order, nested as the reference's associativity allows:
    # the reference merge's payload and spans.
    nested = merge_results([RunResult.from_json(raw[2]),
                            merge_results([RunResult.from_json(raw[1]),
                                           RunResult.from_json(raw[0])])])
    assert _payload(nested) == _payload(theirs)
    assert nested.extra["history_spans"] == theirs.extra["history_spans"]
    problem = NocProblem(spec=named_spec("tiny"), traffic="BFS",
                         case="case3")
    ctx = problem.context(problem.evaluator(device="cpu"))
    ref_ctx = ref_problem.context(ref_problem.evaluator())
    with_phv = merge_results([RunResult.from_json(r) for r in raw], ctx=ctx)
    ref_phv = ref_dist.merge_results(
        [ref_noc.RunResult.from_json(r) for r in raw], ctx=ref_ctx)
    assert with_phv.extra["phv"] == pytest.approx(ref_phv.extra["phv"],
                                                  rel=1e-6)


# ---------------------------------------------------------------------------
# The distributed driver
# ---------------------------------------------------------------------------
def test_stage_dist_serial_w1_byte_identical_to_stage_batch(tiny_problem):
    """The W=1 serial run reproduces a registry ``stage_batch`` run
    byte-for-byte (wall-clock zeroed); only the driver-naming headers
    differ."""
    budget = Budget(max_evals=150, seed=3)
    ref = run(tiny_problem, "stage_batch", budget=budget,
              config=dict(SMALL, n_starts=1), device="cpu")
    dist = _dist(tiny_problem, budget, **SMALL, n_workers=1,
                 executor="serial", n_starts=1)
    assert dist.optimizer == "stage_dist"
    assert _payload(dist) == _payload(ref)
    assert dist.phv() == ref.phv()
    dist2 = _dist(tiny_problem, budget, **SMALL, n_workers=1,
                  executor="serial", n_starts=1)
    assert _payload(dist2) == _payload(dist)


@pytest.mark.parametrize("sync_every", [0, 1])
def test_stage_dist_executors_agree(tiny_problem, sync_every):
    """The executor chooses WHERE shards run, never the result: serial and
    spmd (whose evaluator splits every batch, here across three chunks on
    the CPU) produce identical payloads."""
    budget = Budget(max_evals=240, seed=0)
    cfg = dict(SMALL, n_workers=3, sync_every=sync_every)
    ser = _dist(tiny_problem, budget, **cfg, executor="serial")
    spmd = _dist(tiny_problem, budget, **cfg, executor="spmd")
    assert _payload(spmd) == _payload(ser)
    assert _pareto_sig(spmd) == _pareto_sig(ser)
    assert ser.extra["worker_seeds"] == spawn_seeds(0, 3)
    assert spmd.extra["executor"] == "spmd"


def test_split_evaluator_rows_equal_the_serial_evaluator(tiny_problem):
    """The spmd evaluator's batch split: contiguous chunks, rows in order,
    bit-equal to the unsplit evaluator, one call per batch, delta off."""
    from repro_torch.core.problem import random_design, spec_16

    for problem in (tiny_problem,
                    NocProblem(spec=spec_16(), traffic="BP", case="case5")):
        rng = np.random.default_rng(0)
        designs = [random_design(problem.spec, rng) for _ in range(13)]
        serial = problem.evaluator(device="cpu")
        for n_dev in (1, 2, 5, 20):
            split = problem.evaluator(device="cpu",
                                      split_devices=["cpu"] * n_dev)
            assert not split.delta_on
            rows, aux = split.batch_aux(designs)
            want, want_aux = serial.batch_aux(designs)
            assert np.array_equal(rows, want)
            assert np.array_equal(aux["net_lat"], want_aux["net_lat"])
            assert (split.n_evals, split.n_calls) == (13, 1)
        assert problem.evaluator(device="cpu", split_devices=["cpu"],
                                 delta="on").delta_on is False


def test_cuda_executor_needs_a_card_and_jax_is_refused(tiny_problem):
    budget = Budget(max_evals=120, seed=0)
    cfg = dict(SMALL, n_workers=2)
    with pytest.raises(ValueError, match="'cuda'"):
        _dist(tiny_problem, budget, **cfg, executor="jax")
    from repro_torch.noc.optimizers import StageDistConfig
    with pytest.raises(ValueError, match="'cuda'"):
        StageDistConfig(executor="jax")
    with pytest.raises(ValueError, match="'cuda'"):
        dist_worker.execute_shards(int, [("1",)], "jax")
    # A CPU run cannot take the executor that places shards on cards.
    with pytest.raises(ValueError, match="CUDA devices"):
        _dist(tiny_problem, budget, **cfg, executor="cuda")
    if torch.cuda.is_available():
        on_card = run(tiny_problem, "stage_dist", budget=budget,
                      config=dict(cfg, executor="cuda"))
        assert on_card.extra["executor"] == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            dist_worker.execute_shards(int, [("1",)], "cuda")
        for executor in ("serial", "process", "cuda", "spmd"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                run(tiny_problem, "stage_dist", budget=budget,
                    config=dict(cfg, executor=executor))


def test_coordinator_refuses_single_process_injections(tiny_problem):
    ev = tiny_problem.evaluator(device="cpu")
    with pytest.raises(ValueError, match="owns its RunResult"):
        run(tiny_problem, "stage_dist", budget=Budget(max_evals=50),
            config=dict(SMALL, n_workers=2), ev=ev, device="cpu")
    with pytest.raises(ValueError, match="owns its RunResult"):
        run(tiny_problem, "stage_dist", budget=Budget(max_evals=50),
            config=dict(SMALL, n_workers=2), ctx=tiny_problem.context(ev),
            device="cpu")
    with pytest.raises(ValueError, match="callback"):
        run(tiny_problem, "stage_dist", budget=Budget(max_evals=50),
            config=dict(SMALL, n_workers=2), callback=print, device="cpu")
    with pytest.raises(ValueError, match="track_phv"):
        run(tiny_problem, "stage_dist", budget=Budget(max_evals=50),
            config=dict(SMALL, n_workers=2), track_phv=True, device="cpu")


def test_stage_dist_worker_failure_is_survivable(tiny_problem, monkeypatch):
    """A raising worker lands in diagnostics and the merged Pareto set of
    the SURVIVING workers comes back instead of a crash."""
    real = dist_worker.run_shard
    seeds_seen = []

    def flaky(problem_json, budget_json, seed, config_json=None,
              worker_id=0, **kw):
        if worker_id == 1:
            seeds_seen.append(seed)
            raise RuntimeError("simulated worker crash")
        return real(problem_json, budget_json, seed, config_json,
                    worker_id=worker_id, **kw)

    monkeypatch.setattr(dist_worker, "run_shard", flaky)
    res = _dist(tiny_problem, Budget(max_evals=360, seed=7), **SMALL,
                n_workers=3, executor="serial")
    fails = res.extra["worker_failures"]
    assert [(f["worker_id"], f["round"], f["attempt"], f["phase"])
            for f in fails] == [(1, 0, 0, "run"), (1, 0, 1, "run")]
    assert all(f["error"] == "RuntimeError: simulated worker crash"
               for f in fails)
    assert all('raise RuntimeError("simulated worker crash")'
               in f["traceback"] for f in fails)
    # The retry was a DIFFERENT trajectory: reseeded via retry_seed.
    assert seeds_seen == [seeds_seen[0], retry_seed(seeds_seen[0], 1)]
    assert len(res.designs) >= 1 and np.isfinite(res.phv())
    assert [w for w, _, _ in res.extra["history_spans"]] == [0, 2]
    assert res.n_evals == sum(w["n_evals"] for w in res.extra["workers"])

    def always_fail(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(dist_worker, "run_shard", always_fail)
    with pytest.raises(RuntimeError, match="all 2 workers failed"):
        _dist(tiny_problem, Budget(max_evals=100), **SMALL, n_workers=2,
              executor="serial")


def test_stage_dist_budget_trip_merges_exhausted(tiny_problem):
    res = _dist(tiny_problem, Budget(max_evals=60, seed=0), **SMALL,
                n_workers=2, executor="serial")
    assert res.exhausted
    assert all(w["exhausted"] for w in res.extra["workers"])
    res2 = _dist(tiny_problem, Budget(max_calls=6, seed=0), **SMALL,
                 n_workers=2, executor="serial")
    assert res2.exhausted and len(res2.designs) >= 1
    res3 = _dist(tiny_problem, Budget(max_calls=8, seed=0), **SMALL,
                 n_workers=2, executor="serial", sync_every=1)
    assert res3.exhausted
    assert res3.n_calls <= 8 + 2  # cap + one in-flight dispatch per worker


def test_stage_dist_sync_deterministic_and_budgeted(tiny_problem):
    budget = Budget(max_evals=300, seed=1)
    cfg = dict(SMALL, n_workers=2, executor="serial", sync_every=1,
               iters_max=3)
    r1 = _dist(tiny_problem, budget, **cfg)
    r2 = _dist(tiny_problem, budget, **cfg)
    assert _payload(r1) == _payload(r2)
    assert r1.extra["history_spans"] == r2.extra["history_spans"]
    per_worker = 2 * (SMALL["n_swaps"] + SMALL["n_link_moves"]) + 2
    assert r1.n_evals <= 300 + 2 * per_worker
    wids = [w for w, _, _ in r1.extra["history_spans"]]
    assert len(wids) == len(set(wids))
    sub = np.asarray(r1.objs)[:, list(r1.obj_idx)]
    for i in range(sub.shape[0]):
        for j in range(sub.shape[0]):
            if i != j:
                assert not dominates(sub[i], sub[j])


def test_stage_dist_sync_worker_failure_drops_later_rounds(
        tiny_problem, monkeypatch):
    real = dist_worker.run_shard_round
    calls = []

    def flaky(problem_json, budget_json, seed, config_json=None,
              worker_id=0, starts_json=None, train_x=None, train_y=None,
              global_json=None, **kw):
        from repro_torch.dist.sync import ROUND_TAG_STRIDE

        wid, rnd = divmod(worker_id, ROUND_TAG_STRIDE)
        calls.append((wid, rnd))
        if wid == 1 and rnd == 1:
            raise RuntimeError("dies in round 1")
        return real(problem_json, budget_json, seed, config_json,
                    worker_id=worker_id, starts_json=starts_json,
                    train_x=train_x, train_y=train_y,
                    global_json=global_json, **kw)

    monkeypatch.setattr(dist_worker, "run_shard_round", flaky)
    res = _dist(tiny_problem, Budget(max_evals=300, seed=2),
                **dict(SMALL, iters_max=3), n_workers=2, executor="serial",
                sync_every=1)
    fails = res.extra["worker_failures"]
    assert [(f["worker_id"], f["round"], f["attempt"]) for f in fails] \
        == [(1, 1, 0), (1, 1, 1)]
    assert all(f["error"] == "RuntimeError: dies in round 1"
               and f["phase"] == "run" for f in fails)
    assert (1, 2) not in calls
    assert (0, 2) in calls
    assert len(res.designs) >= 1


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stage_dist_serial_w3_holds_against_the_reference(tiny_problem,
                                                          seed):
    """``stage_dist`` serial, W=3: every worker's shard gives the
    reference's front, or parts at a knife-edge whose replay on the
    reference's rows is the reference's run bit for bit; where no worker
    parts, the merged runs agree too."""
    ref_problem = ref_noc.NocProblem(spec=ref_noc.named_spec("tiny"),
                                     traffic="BFS", case="case3")
    budget = Budget(max_evals=240, seed=seed)
    cfg = dict(SMALL, n_starts=1)
    parted = []
    for s in plan_shards(tiny_problem, budget, 3):
        _, _, part = hold_runs(
            lambda ev: run(tiny_problem, "stage_batch", s.budget, config=cfg,
                           ev=ev),
            lambda: tiny_problem.evaluator(device="cpu"),
            lambda ev: ref_noc.run(ref_problem, "stage_batch",
                                   ref_noc.Budget(**s.budget.to_json()),
                                   config=cfg, ev=ev),
            ref_problem.evaluator, ULPS8)
        parted.append(part["parted"])
    ours = _dist(tiny_problem, budget, **SMALL, n_workers=3,
                 executor="serial")
    theirs = ref_noc.run(ref_problem, "stage_dist",
                         budget=ref_noc.Budget(max_evals=240, seed=seed),
                         config=dict(SMALL, n_workers=3, executor="serial"))
    assert ours.extra["worker_seeds"] == theirs.extra["worker_seeds"]
    if not any(parted):
        assert [d.key() for d in ours.designs] == [d.key()
                                                   for d in theirs.designs]
        np.testing.assert_allclose(ours.objs, theirs.objs, rtol=ULPS8,
                                   atol=0)
        assert (ours.n_evals, ours.n_calls) == (theirs.n_evals,
                                                theirs.n_calls)
        assert ours.extra["history_spans"] == theirs.extra["history_spans"]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_cli_stage_dist_workers_flag(capsys, tmp_path):
    from repro_torch.noc import cli

    out = tmp_path / "dist.json"
    rc = cli.main([
        "run", "--spec", "tiny", "--optimizer", "stage_dist",
        "--workers", "2", "--max-evals", "120", "--seed", "0",
        "--set", "iters_max=1", "--set", "n_swaps=3",
        "--set", "n_link_moves=3", "--set", "max_local_steps=3",
        "--out", str(out), "--quiet", "--device", "cpu"])
    assert rc == 0
    saved = RunResult.load(out)
    assert saved.optimizer == "stage_dist"
    assert saved.config["n_workers"] == 2
    # The reference reads the port's merged result.
    assert ref_noc.RunResult.load(out).config["n_workers"] == 2
    with pytest.raises(SystemExit, match="only applies"):
        cli.main(["run", "--optimizer", "stage", "--workers", "2",
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="only apply"):
        cli.main(["run", "--optimizer", "stage", "--checkpoint-dir",
                  str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="requires --checkpoint-dir"):
        cli.main(["run", "--optimizer", "stage_dist", "--resume",
                  "--device", "cpu"])


def test_cli_resume_round_trip(tmp_path):
    from repro_torch.noc import cli

    args = ["run", "--spec", "tiny", "--optimizer", "stage_dist",
            "--workers", "2", "--max-evals", "120", "--seed", "1",
            "--set", "iters_max=2", "--set", "n_swaps=3",
            "--set", "n_link_moves=3", "--set", "max_local_steps=3",
            "--set", "sync_every=1", "--quiet", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ck")]
    assert cli.main(args + ["--out", str(tmp_path / "a.json")]) == 0
    assert cli.main(args + ["--resume", "--out",
                            str(tmp_path / "b.json")]) == 0
    a, b = (RunResult.load(tmp_path / n) for n in ("a.json", "b.json"))
    assert _payload(a) == _payload(b)
    assert b.extra["resumed_from_round"] is not None


# ---------------------------------------------------------------------------
# Equal-budget PHV and the process executor
# ---------------------------------------------------------------------------
@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stage_dist_process_phv_matches_stage_batch(tiny_problem, seed):
    """stage_dist(W=4, process executor) at equal global budget reaches
    PHV on par with single-process stage_batch(n_starts=4) on spec_tiny,
    and the process executor's payload is the serial executor's."""
    budget = Budget(max_evals=2000, seed=seed)
    sb = run(tiny_problem, "stage_batch", budget=budget,
             config=dict(n_starts=4), device="cpu")
    cfg = dict(n_workers=4, n_starts=1, sync_every=6)
    sd = _dist(tiny_problem, budget, **cfg, executor="process")
    assert sd.extra["executor"] == "process"
    assert sd.phv() >= sb.phv() - 0.005, (
        f"seed {seed}: dist {sd.phv():.6f} << batch {sb.phv():.6f}")
    assert sd.n_evals <= 2000 + 4 * (2 * (24 + 24) + 2)
    assert _payload(sd) == _payload(_dist(tiny_problem, budget, **cfg,
                                          executor="serial"))
