"""The multi-tenant NoC-optimization service of the port
(repro_torch.noc.server) on the CPU: the reference's contracts
(tests/test_server.py and the two server tests of tests/test_workloads.py),
and the canonical request key — the name of a journal entry — equal to the
reference's, byte for byte, for the same request JSON.

Contract under test, layer by layer:

* admission — malformed problems/budgets/configs are rejected at the
  door as structured ``{"error": {"code", "message"}}`` dicts, never by
  crashing a worker; bounded queue + per-tenant caps are backpressure.
* cache — the canonical request key is invariant to JSON dict ordering,
  float spelling, and omitted back-compat defaults; a duplicate request
  is served at submit time with ``n_evals == 0``; a different seed is a
  different request; partial results never enter the cache.
* degradation — deadlines and cancellation finalize a running request
  as its best-so-far front with ``extra["partial"] = True``.
* equality — one service request is byte-identical (canonical payload,
  wall zeroed) to the same run through ``run(..., "stage_dist")``.
* journal — stale ``tmp.*`` sweep parity, completed-checkpoint gc, and
  the crash-recovery matrix (result-committed-but-status-unflipped is
  adopted as done; a mid-write crash leaves only a swept tmp).
"""

import json
import os

import numpy as np
import pytest
import torch

import repro.noc.server as ref_server
from repro_torch.core import spec_tiny
from repro_torch.noc import Budget, NocProblem, RunResult
from repro_torch.noc import run as _run
from repro_torch.noc.optimizers import StageDistConfig
from repro_torch.noc.server import (Client, NocService, RequestJournal,
                                    ServiceConfig, canonical_request_key,
                                    normalize_config, serve_stdio,
                                    validate_request)

SMALL = dict(iters_max=2, n_swaps=4, n_link_moves=4, max_local_steps=5)


def run(*args, **kwargs):
    """``repro_torch.noc.run`` on the CPU."""
    return _run(*args, device="cpu", **kwargs)


@pytest.fixture(scope="module")
def tiny_problem() -> NocProblem:
    return NocProblem(spec=spec_tiny(), traffic="BFS", case="case3")


def _payload(res: RunResult) -> str:
    """Canonical payload (the test_dist canon): wall zeroed everywhere —
    history column 0 is a wall-clock stamp — header fields excluded."""
    j = res.to_json()
    j["history"] = [[0.0] + row[1:] for row in j["history"]]
    keep = ("problem", "budget", "obj_idx", "designs", "objs", "history",
            "n_evals", "n_calls", "exhausted")
    return json.dumps({k: j[k] for k in keep}, sort_keys=True)


def _norm(problem, budget=None, **cfg):
    """Admission pipeline shorthand → (normalized cfg, key)."""
    b = budget if budget is not None else Budget(max_evals=60, seed=0)
    c = normalize_config(StageDistConfig(**cfg), executor="serial",
                         shard_timeout_s=None, max_retries=1,
                         retry_backoff_s=0.0)
    return c, canonical_request_key(problem, b, c)


# ==========================================================================
# admission control + backpressure
# ==========================================================================
def test_admission_structured_errors(tiny_problem):
    pj = tiny_problem.to_json()
    bj = Budget(max_evals=60, seed=0).to_json()
    with Client.local(device="cpu", n_workers=1) as c:
        assert c.submit("nope", bj)["error"]["code"] == "invalid_problem"
        assert c.submit({"spec": {"nx": -3}}, bj
                        )["error"]["code"] == "invalid_problem"
        assert c.submit(pj, [1, 2])["error"]["code"] == "invalid_budget"
        # unbounded budgets would hold fleet slots forever
        unbounded = c.submit(pj, {"max_evals": None, "max_calls": None,
                                  "seed": 0})
        assert unbounded["error"]["code"] == "invalid_budget"
        assert "bounded" in unbounded["error"]["message"]
        assert c.submit(pj, bj, {"sync_every": "lots"}
                        )["error"]["code"] == "invalid_config"
        owned = c.submit(pj, bj, {"checkpoint_dir": "/tmp/x"})
        assert owned["error"]["code"] == "invalid_config"
        assert "service-owned" in owned["error"]["message"]
        assert c.submit(pj, bj, deadline_s=-1.0
                        )["error"]["code"] == "invalid_deadline"
        ok = c.submit(pj, bj, dict(SMALL), request_id="r0")
        assert ok == {"id": "r0", "status": "queued", "cache_hit": False}
        assert c.submit(pj, bj, request_id="r0"
                        )["error"]["code"] == "duplicate_id"
        # unknown ids are structured errors on every query surface
        for resp in (c.status("ghost"), c.result("ghost"), c.cancel("ghost")):
            assert resp["error"]["code"] == "unknown_request"


def test_backpressure_queue_and_tenant_caps(tiny_problem):
    pj = tiny_problem.to_json()
    cfg = ServiceConfig(device="cpu",
                        n_workers=1, max_queue=2, max_inflight_per_tenant=1)
    with Client(NocService(cfg)) as c:
        def sub(seed, tenant):
            return c.submit(pj, Budget(max_evals=60, seed=seed).to_json(),
                            dict(SMALL), tenant=tenant)

        assert sub(0, "alice")["status"] == "queued"
        # per-tenant cap fires before the queue bound
        assert sub(1, "alice")["error"]["code"] == "tenant_cap"
        assert sub(1, "bob")["status"] == "queued"
        assert sub(2, "carol")["error"]["code"] == "queue_full"
        c.drain()                       # completion frees the slots
        assert sub(2, "carol")["status"] == "queued"


# ==========================================================================
# canonical request key + result cache
# ==========================================================================
def test_key_invariant_to_dict_ordering(tiny_problem):
    pj = tiny_problem.to_json()
    shuffled = json.loads(json.dumps(
        {k: pj[k] for k in reversed(list(pj))}))
    p1, b1, c1 = validate_request(pj, {"max_evals": 60, "seed": 0})
    p2, b2, c2 = validate_request(shuffled, {"seed": 0, "max_evals": 60})
    assert canonical_request_key(p1, b1, c1) == \
        canonical_request_key(p2, b2, c2)


def test_key_invariant_to_float_spelling(tiny_problem):
    # "60", "60.0" and "6e1" are the same budget — JSON spelling must
    # not split the cache.
    keys = set()
    for text in ('{"max_evals": 60, "seed": 0}',
                 '{"max_evals": 60.0, "seed": 0}',
                 '{"max_evals": 6e1, "seed": 0}'):
        _, b, c = validate_request(tiny_problem.to_json(), json.loads(text))
        keys.add(canonical_request_key(tiny_problem, b, c))
    assert len(keys) == 1


def test_key_invariant_to_backcompat_defaults(tiny_problem):
    pj = tiny_problem.to_json()
    bare = {k: v for k, v in pj.items()
            if k not in ("backend", "forest_backend")}
    p1, b1, c1 = validate_request(pj, {"max_evals": 60, "seed": 0}, {})
    p2, b2, c2 = validate_request(bare, {"max_evals": 60, "seed": 0},
                                  {"n_workers": 4})   # 4 is the default
    assert canonical_request_key(p1, b1, c1) == \
        canonical_request_key(p2, b2, c2)


def test_key_distinguishes_seed_and_trajectory(tiny_problem):
    _, k0 = _norm(tiny_problem, Budget(max_evals=60, seed=0))
    _, k1 = _norm(tiny_problem, Budget(max_evals=60, seed=1))
    _, k2 = _norm(tiny_problem, Budget(max_evals=60, seed=0), iters_max=7)
    assert len({k0, k1, k2}) == 3
    # fleet knobs change where a request runs, never what it returns
    c_a = normalize_config(StageDistConfig(), executor="serial",
                           shard_timeout_s=None, max_retries=1,
                           retry_backoff_s=0.0)
    c_b = normalize_config(StageDistConfig(), executor="cuda",
                           shard_timeout_s=9.0, max_retries=3,
                           retry_backoff_s=0.5)
    b = Budget(max_evals=60, seed=0)
    assert canonical_request_key(tiny_problem, b, c_a) == \
        canonical_request_key(tiny_problem, b, c_b)


def test_duplicate_served_from_cache(tiny_problem):
    pj = tiny_problem.to_json()
    bj = Budget(max_evals=60, seed=0).to_json()
    with Client.local(device="cpu", n_workers=2) as c:
        first = c.submit(pj, bj, dict(SMALL))
        c.drain()
        orig = c.result(first["id"])
        # dict-reordered + float-spelled duplicate: served at the door
        dup = c.submit({k: pj[k] for k in reversed(list(pj))},
                       json.loads('{"max_evals": 6e1, "seed": 0}'),
                       dict(SMALL))
        assert dup["status"] == "done" and dup["cache_hit"] is True
        hit = c.result(dup["id"])
        assert hit.n_evals == 0 and hit.n_calls == 0 and hit.wall_s == 0.0
        assert hit.extra["cache_hit"] is True
        hj, oj = hit.to_json(), orig.to_json()
        assert hj["designs"] == oj["designs"] and hj["objs"] == oj["objs"]
        # a different seed is a different request — no hit
        miss = c.submit(pj, Budget(max_evals=60, seed=1).to_json(),
                        dict(SMALL))
        assert miss["cache_hit"] is False and miss["status"] == "queued"


# ==========================================================================
# deadlines, cancellation, graceful degradation
# ==========================================================================
def test_deadline_finalizes_partial(tiny_problem):
    pj = tiny_problem.to_json()
    with Client.local(device="cpu", n_workers=2) as c:
        ack = c.submit(pj, Budget(max_evals=10_000, seed=0).to_json(),
                       dict(SMALL, iters_max=50), deadline_s=1e-3)
        c.drain()
        st = c.status(ack["id"])
        assert st["status"] == "partial" and st["error"] == "deadline"
        res = c.result(ack["id"])
        assert res.extra["partial"] is True and res.extra["note"] == "deadline"
        assert res.exhausted is True
        # partial results never enter the cache: a full-budget twin
        # must not be served a truncated front
        dup = c.submit(pj, Budget(max_evals=10_000, seed=0).to_json(),
                       dict(SMALL, iters_max=50))
        assert dup["cache_hit"] is False


def test_cancel_queued_and_running(tiny_problem):
    pj = tiny_problem.to_json()
    with Client.local(device="cpu", n_workers=2) as c:
        q = c.submit(pj, Budget(max_evals=60, seed=0).to_json(), dict(SMALL))
        assert c.cancel(q["id"])["status"] == "cancelled"
        assert c.result(q["id"])["error"]["code"] == "request_failed"
        r = c.submit(pj, Budget(max_evals=60, seed=1).to_json(), dict(SMALL))
        c.step()                               # one wave: now running
        st = c.cancel(r["id"])
        assert st["status"] == "partial" and st["error"] == "cancelled"
        res = c.result(r["id"])
        assert isinstance(res, RunResult) and res.extra["partial"] is True
        assert len(res.designs) >= 1           # best-so-far, not empty
        assert not c.step()                    # slots reclaimed: idle


# ==========================================================================
# equality with the single-request driver
# ==========================================================================
def test_service_request_matches_run_dist(tiny_problem):
    cfg = dict(SMALL, n_workers=2, sync_every=1)
    budget = Budget(max_evals=120, seed=0)
    ref = run(tiny_problem, "stage_dist", budget=budget, config=cfg)
    with Client.local(device="cpu", n_workers=2) as c:
        ack = c.submit(tiny_problem.to_json(), budget.to_json(), cfg)
        c.drain()
        svc = c.result(ack["id"])
    assert _payload(svc) == _payload(ref)


# ==========================================================================
# journal: sweep parity, gc, crash-recovery matrix
# ==========================================================================
def test_journal_sweeps_stale_tmp_everywhere(tmp_path):
    root = tmp_path / "journal"
    j = RequestJournal(str(root))
    j.save_request({"id": "r0", "seq": 0, "status": "queued"})
    # a crash mid-write leaves tmp orphans in the root and in req dirs
    (root / "tmp.abc.request.json").write_text("{torn")
    (root / "req_000000" / "tmp.def.result.json").write_text("{torn")
    j2 = RequestJournal(str(root))
    assert not list(root.glob("**/tmp.*"))
    assert j2.load_request(0)["id"] == "r0"     # real record untouched


def test_journal_gc_keeps_last_k(tmp_path):
    j = RequestJournal(str(tmp_path / "journal"))
    for seq in range(5):
        status = "done" if seq < 4 else "running"
        j.save_request({"id": f"r{seq}", "seq": seq, "status": status})
        os.makedirs(j.rounds_dir(seq), exist_ok=True)
    removed = j.gc_completed(keep=2)
    assert removed == [0, 1]
    # terminal 2, 3 keep their rounds; running 4 is never touched
    assert [seq for seq in range(5)
            if os.path.isdir(j.rounds_dir(seq))] == [2, 3, 4]
    assert j.gc_completed(keep=2) == []          # idempotent
    # records + results survive gc — they are the cache
    assert j.load_request(0)["id"] == "r0"


def test_service_gcs_completed_checkpoints(tiny_problem, tmp_path):
    cfg = ServiceConfig(device="cpu",
                        n_workers=1, journal_dir=str(tmp_path / "j"),
                        keep_completed=1, max_inflight_per_tenant=3)
    with Client(NocService(cfg)) as c:
        pj = tiny_problem.to_json()
        for seed in range(3):
            ack = c.submit(pj, Budget(max_evals=60, seed=seed).to_json(),
                           dict(SMALL))
            assert ack["status"] == "queued", ack
        c.drain()
        j = c.service.journal
        kept = [seq for seq in j.seqs() if os.path.isdir(j.rounds_dir(seq))]
        assert kept == [2]                       # only the newest
        assert all(j.load_result(seq) is not None for seq in range(3))


def test_recovery_matrix_in_process(tiny_problem, tmp_path):
    """queued→requeue, running+ckpt→restore, done→cache; the resumed
    service's results are byte-identical to the uninterrupted run's."""
    pj = tiny_problem.to_json()
    budgets = [Budget(max_evals=120, seed=s) for s in (0, 1, 2)]
    cfg = dict(SMALL, sync_every=1, n_workers=2)

    ref = {}
    with Client.local(device="cpu",
                      n_workers=2, max_inflight_per_tenant=3) as c:
        for b in budgets:
            ack = c.submit(pj, b.to_json(), cfg)
            ref[b.seed] = ack["id"]
        c.drain()
        ref = {s: _payload(c.result(rid)) for s, rid in ref.items()}

    jdir = str(tmp_path / "j")
    svc = NocService(ServiceConfig(device="cpu", n_workers=2, journal_dir=jdir,
                                   max_inflight_per_tenant=3))
    ids = {}
    for b in budgets[:2]:
        ids[b.seed] = svc.submit(pj, b.to_json(), cfg)["id"]
    svc.step()                                   # seeds 0,1 now running
    svc.shutdown()                               # "crash" at a wave boundary

    svc2 = NocService(ServiceConfig(device="cpu",
                                    n_workers=2, journal_dir=jdir,
                                    max_inflight_per_tenant=3))
    # a request admitted before the crash but never started: queued
    ids[2] = svc2.submit(pj, budgets[2].to_json(), cfg)["id"]
    assert svc2.status(ids[0])["status"] == "running"
    assert svc2.status(ids[0])["rounds_done"] >= 1   # restored, not reset
    svc2.run_until_idle()
    for s in (0, 1, 2):
        assert _payload(svc2.result(ids[s])) == ref[s]
    svc2.shutdown()


def test_recovery_adopts_committed_result(tiny_problem, tmp_path):
    """Crash between the result write (the commit point) and the status
    flip: recovery adopts the request as completed, replaying nothing."""
    jdir = str(tmp_path / "j")
    pj = tiny_problem.to_json()
    bj = Budget(max_evals=60, seed=0).to_json()
    with Client(NocService(ServiceConfig(device="cpu", 
            n_workers=1, journal_dir=jdir))) as c:
        rid = c.submit(pj, bj, dict(SMALL))["id"]
        c.drain()
        want = _payload(c.result(rid))
        j = c.service.journal
        rec = j.load_request(0)
        rec["status"] = "running"                # un-flip: simulate the crash
        j.save_request(rec)

    svc2 = NocService(ServiceConfig(device="cpu",
                                    n_workers=1, journal_dir=jdir))
    assert svc2.status(rid)["status"] == "done"
    assert _payload(svc2.result(rid)) == want
    # ... and the adopted result re-seeds the cache
    dup = svc2.submit(pj, bj, dict(SMALL))
    assert dup["cache_hit"] is True
    svc2.shutdown()


def test_crash_mid_request_write_recovers(tiny_problem, tmp_path):
    """A server killed mid-``request.json`` write leaves a tmp orphan and
    the previous record — recovery sweeps the tmp and resumes from the
    last durable state."""
    jdir = str(tmp_path / "j")
    pj = tiny_problem.to_json()
    svc = NocService(ServiceConfig(device="cpu",
                                   n_workers=1, journal_dir=jdir))
    rid = svc.submit(pj, Budget(max_evals=60, seed=0).to_json(),
                     dict(SMALL))["id"]
    svc.step()
    svc.shutdown()
    # torn write: a tmp the atomic rename never happened for
    j = RequestJournal(jdir)
    torn = os.path.join(j.req_dir(0), "tmp.xyz.request.json")
    with open(torn, "w") as fh:
        fh.write('{"id": "r0", "status": "don')

    svc2 = NocService(ServiceConfig(device="cpu",
                                    n_workers=1, journal_dir=jdir))
    assert not os.path.exists(torn)
    assert svc2.status(rid)["status"] == "running"
    svc2.run_until_idle()
    assert svc2.status(rid)["status"] == "done"
    svc2.shutdown()


# ==========================================================================
# stdio protocol plumbing
# ==========================================================================
def test_serve_stdio_protocol(tiny_problem):
    import io

    pj, bj = tiny_problem.to_json(), Budget(max_evals=60, seed=0).to_json()
    lines = [
        "this is not json",
        json.dumps({"op": "frobnicate"}),
        json.dumps({"op": "submit", "problem": pj, "budget": bj,
                    "config": dict(SMALL), "request_id": "r0"}),
        json.dumps({"op": "drain"}),
        json.dumps({"op": "result", "id": "r0"}),
        json.dumps({"op": "shutdown"}),
        json.dumps({"op": "status"}),            # after shutdown: unread
    ]
    out = io.StringIO()
    serve_stdio(NocService(ServiceConfig(device="cpu", n_workers=1)),
                stdin=io.StringIO("\n".join(lines) + "\n"), stdout=out)
    got = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [g.get("error", {}).get("code") for g in got[:2]] == \
        ["bad_json", "unknown_op"]
    assert got[2] == {"id": "r0", "status": "queued", "cache_hit": False}
    assert got[3]["by_status"] == {"done": 1}
    assert RunResult.from_json(got[4]["result"]).n_evals > 0
    assert got[5] == {"ok": True}
    assert len(got) == 6                         # loop ended at shutdown


# ==========================================================================
# the canonical key against the reference's
# ==========================================================================
REQUESTS = [
    ({"max_evals": 60, "seed": 0}, None),
    ({"max_evals": 6e1, "seed": 0}, {}),
    ({"seed": 3, "max_evals": 2000, "max_calls": 40}, {"n_workers": 2}),
    ({"max_evals": 500, "seed": 1}, dict(SMALL, sync_every=1)),
    ({"max_evals": 120.0, "seed": 2}, {"iters_max": 7, "n_starts": 2,
                                       "forest_backend": "numpy"}),
    ({"max_evals": 60, "seed": 0}, {"forest_kwargs": {"n_trees": 8}}),
]
TRAFFIC = ["BFS", {"avg": ["BFS", "BP"]}, {"model": "yi-6b",
                                           "phase": "serve.decode"}]


@pytest.mark.parametrize("budget_json,config_json", REQUESTS)
@pytest.mark.parametrize("traffic", range(len(TRAFFIC)))
def test_canonical_key_equals_the_reference(tiny_problem, budget_json,
                                            config_json, traffic):
    t = TRAFFIC[traffic]
    pj = dict(tiny_problem.to_json(),
              traffic=t if isinstance(t, dict) else {"app": t})
    keys = set()
    for problem_json in (pj, {k: pj[k] for k in reversed(list(pj))},
                         {k: v for k, v in pj.items()
                          if k not in ("backend", "forest_backend")}):
        ours = validate_request(problem_json, budget_json, config_json)
        theirs = ref_server.validate_request(problem_json, budget_json,
                                             config_json)
        for executor in ("serial", "process"):
            ours_cfg = normalize_config(
                ours[2], executor=executor, shard_timeout_s=None,
                max_retries=1, retry_backoff_s=0.0)
            theirs_cfg = ref_server.normalize_config(
                theirs[2], executor=executor, shard_timeout_s=None,
                max_retries=1, retry_backoff_s=0.0)
            key = canonical_request_key(ours[0], ours[1], ours_cfg)
            assert key == ref_server.canonical_request_key(*theirs[:2],
                                                           theirs_cfg)
            keys.add(key)
    assert len(keys) == 1       # order, defaults and fleet knobs: one key


def test_admission_errors_equal_the_reference(tiny_problem):
    """The same structured error codes at the door for the same bad
    requests."""
    pj = tiny_problem.to_json()
    bj = Budget(max_evals=60, seed=0).to_json()
    bad = [("nope", bj, None), ({"spec": {"nx": -3}}, bj, None),
           (pj, [1, 2], None), (pj, {"max_evals": None, "max_calls": None,
                                     "seed": 0}, None),
           (pj, bj, {"sync_every": "lots"}),
           (pj, bj, {"checkpoint_dir": "/tmp/x"}),
           (pj, bj, {"executor": "process"}),
           (dict(pj, traffic={"model": "not-a-model"}), bj, None)]
    from repro_torch.noc.server import AdmissionRejected

    for problem_json, budget_json, config_json in bad:
        with pytest.raises(AdmissionRejected) as ours:
            validate_request(problem_json, budget_json, config_json)
        with pytest.raises(ref_server.AdmissionRejected) as theirs:
            ref_server.validate_request(problem_json, budget_json,
                                        config_json)
        assert ours.value.code == theirs.value.code


def test_service_needs_a_card_unless_told_otherwise():
    from repro_torch.noc.server import ServiceConfig as Cfg

    with pytest.raises(ValueError, match="'cuda'"):
        Cfg(executor="jax")
    with pytest.raises(ValueError, match="device"):
        Cfg(device="mps")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            NocService(Cfg())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            NocService(Cfg(executor="process"))
    with NocService(Cfg(device="cpu")) as svc:
        assert svc.device == "cpu"


# ==========================================================================
# the server tests of tests/test_workloads.py
# ==========================================================================
def test_admission_rejects_invalid_traffic():
    spec = spec_tiny()
    n = spec.n_tiles
    bj = Budget(max_evals=60, seed=0).to_json()
    ok = NocProblem(spec=spec, traffic="BFS").to_json()
    with Client.local(device="cpu", n_workers=1) as c:
        for traffic in (
            {"model": "not-a-model"},
            {"model": "yi-6b", "phase": "train.nope"},
            {"matrix": np.full((n, n), np.nan).tolist()},
            {"matrix": (-np.ones((n, n))).tolist()},
            {"matrix": np.zeros((n, n)).tolist()},
        ):
            pj = dict(ok, traffic=traffic)
            resp = c.submit(pj, bj)
            assert resp["error"]["code"] == "invalid_traffic", traffic


def test_server_runs_model_traffic_end_to_end():
    pj = NocProblem(spec=spec_tiny(),
                    traffic={"model": "yi-6b",
                             "phase": "serve.decode"}).to_json()
    bj = Budget(max_evals=60, seed=0).to_json()
    with Client.local(device="cpu", n_workers=1) as c:
        assert c.submit(pj, bj, dict(SMALL), request_id="m0")[
            "status"] == "queued"
        c.drain()
        assert c.status("m0")["status"] == "done"
        res = c.result("m0")
        assert len(res.designs) >= 1
        # identical resubmission is a cache hit at the door
        dup = c.submit(pj, bj, dict(SMALL))
        assert dup["cache_hit"] is True
