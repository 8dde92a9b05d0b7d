"""Service chaos acceptance in the port (repro_torch.noc.server), on the
CPU — the reference's contracts (tests/test_server_chaos.py): the
multi-tenant service survives worker aborts, hung shards, slow tenants, scripted admission
rejections, and a SIGKILL'd server — and the survivors' results are
byte-identical to an undisturbed run's.

The headline pin: 4 workers, 4 concurrent tenants, one worker abort +
one hung shard scripted into round 0, the server SIGKILLed mid-run and
restarted against the same journal — every request terminates ``done``,
every result's canonical payload matches the uninterrupted reference,
the failed dispatches are charged to exactly the owning requests'
ledgers, and a duplicate submitted to the restarted server is served
from cache with ``n_evals == 0``.
"""

import json

import pytest

from repro_torch.core import spec_tiny
from repro_torch.dist.state import ROUND_TAG_STRIDE
from repro_torch.noc import Budget, NocProblem, RunResult
from repro_torch.noc.server import (Client, NocService, ServiceConfig,
                                    SubprocessClient)

SMALL = dict(iters_max=2, n_swaps=4, n_link_moves=4, max_local_steps=5)
REQ_CFG = dict(SMALL, n_workers=2, sync_every=1)

#: round-0 chaos: request seq 0 loses worker 0 to a hard abort, request
#: seq 1's worker 1 hangs past the shard deadline. Wave meta tags are
#: ``seq * ROUND_TAG_STRIDE + worker_id`` — the script targets exactly
#: one request each, and the reseeded retry (attempt 1) runs clean.
CHAOS_FAULTS = (
    {"kind": "abort", "worker_id": 0 * ROUND_TAG_STRIDE + 0,
     "round": 0, "attempt": 0},
    {"kind": "hang", "worker_id": 1 * ROUND_TAG_STRIDE + 1,
     "round": 0, "attempt": 0, "hang_s": 6.0},
)
FLEET = dict(n_workers=4, shard_timeout_s=5.0, max_retries=1, device="cpu")


@pytest.fixture(scope="module")
def tiny_problem() -> NocProblem:
    return NocProblem(spec=spec_tiny(), traffic="BFS", case="case3")


def _payload(res: RunResult) -> str:
    j = res.to_json()
    j["history"] = [[0.0] + row[1:] for row in j["history"]]
    keep = ("problem", "budget", "obj_idx", "designs", "objs", "history",
            "n_evals", "n_calls", "exhausted")
    return json.dumps({k: j[k] for k in keep}, sort_keys=True)


def _submit_tenants(client, problem, n=4):
    """n tenants, one request each (seeds 0..n-1), admission order."""
    ids = {}
    for seed in range(n):
        ack = client.submit(problem.to_json(),
                            Budget(max_evals=120, seed=seed).to_json(),
                            dict(REQ_CFG), tenant=f"t{seed}")
        assert ack["status"] == "queued", ack
        ids[seed] = ack["id"]
    return ids


def test_chaos_kill_and_restart_is_byte_identical(tiny_problem, tmp_path):
    # ---- reference: same fleet, same fault script, never killed -------
    with Client(NocService(ServiceConfig(
            faults=CHAOS_FAULTS, **FLEET))) as ref_client:
        ref_ids = _submit_tenants(ref_client, tiny_problem)
        ref_client.drain()
        ref = {s: _payload(ref_client.result(rid))
               for s, rid in ref_ids.items()}

    # ---- chaos: same script over a real process, SIGKILLed mid-run ----
    jdir = str(tmp_path / "journal")
    c1 = SubprocessClient(jdir, faults=CHAOS_FAULTS, **FLEET)
    ids = _submit_tenants(c1, tiny_problem)
    c1.step()
    c1.step()                  # requests mid-flight, checkpoints on disk
    c1.kill()                  # no flush, no goodbye

    c2 = SubprocessClient(jdir, faults=CHAOS_FAULTS, **FLEET)
    c2.drain()
    try:
        # every request terminated, full results, byte-identical
        results = {}
        for seed, rid in ids.items():
            st = c2.status(rid)
            assert st["status"] in ("done", "partial"), st
            assert st["status"] == "done"
            results[seed] = c2.result(rid)
            assert _payload(results[seed]) == ref[seed]

        # ledgers exact: the abort charged tenant t0's request, the hung
        # shard charged t1's — nobody else's
        f0 = results[0].extra["worker_failures"]
        assert [f["worker_id"] for f in f0] == [0]
        assert f0[0]["phase"] == "run" and f0[0]["round"] == 0
        assert "injected abort" in f0[0]["error"]
        f1 = results[1].extra["worker_failures"]
        assert [f["worker_id"] for f in f1] == [1]
        assert f1[0]["phase"] == "timeout" and f1[0]["round"] == 0
        assert results[2].extra["worker_failures"] == []
        assert results[3].extra["worker_failures"] == []

        # a duplicate against the restarted server: served from cache,
        # zero evals — the original request paid
        dup = c2.submit(tiny_problem.to_json(),
                        Budget(max_evals=120, seed=0).to_json(),
                        dict(REQ_CFG), tenant="t9")
        assert dup["cache_hit"] is True
        hit = c2.result(dup["id"])
        assert hit.n_evals == 0 and hit.extra["cache_hit"] is True
        hj = hit.to_json()
        assert json.dumps(hj["designs"]) == \
            json.dumps(results[0].to_json()["designs"])
    finally:
        c2.close()


def test_kill_server_fault_dies_and_recovers(tiny_problem, tmp_path):
    """The scripted ``kill_server`` fault really dies the serve process
    (after the wave's journal hits disk); a restart against the same
    journal finishes the request identically to an unfaulted run."""
    from repro_torch.noc.server import ServerDied

    with Client.local(device="cpu", n_workers=2) as ref_client:
        bj = Budget(max_evals=120, seed=0).to_json()
        rid = ref_client.submit(tiny_problem.to_json(), bj,
                                dict(REQ_CFG))["id"]
        ref_client.drain()
        want = _payload(ref_client.result(rid))

    jdir = str(tmp_path / "journal")
    c1 = SubprocessClient(jdir, n_workers=2, device="cpu",
                          faults=({"kind": "kill_server", "wave": 1},))
    rid = c1.submit(tiny_problem.to_json(), bj, dict(REQ_CFG))["id"]
    with pytest.raises(ServerDied):
        c1.drain()
    c1.close()

    with SubprocessClient(jdir, n_workers=2, device="cpu") as c2:
        c2.drain()
        assert c2.status(rid)["status"] == "done"
        assert _payload(c2.result(rid)) == want


def test_slow_tenant_degrades_only_itself(tiny_problem):
    """An injected slow tenant blows its own deadline and is finalized
    partial; the fast tenant's result is untouched by the chaos."""
    with Client.local(device="cpu", n_workers=2) as plain:
        bj = Budget(max_evals=120, seed=0).to_json()
        rid = plain.submit(tiny_problem.to_json(), bj, dict(REQ_CFG))["id"]
        plain.drain()
        want = _payload(plain.result(rid))

    faults = ({"kind": "slow_tenant", "tenant": "slow", "wave": 0,
               "hang_s": 0.4},)
    with Client.local(device="cpu", n_workers=2, faults=faults) as c:
        slow = c.submit(tiny_problem.to_json(),
                        Budget(max_evals=120, seed=7).to_json(),
                        dict(REQ_CFG), tenant="slow", deadline_s=0.5)
        fast = c.submit(tiny_problem.to_json(), bj, dict(REQ_CFG),
                        tenant="fast")
        c.drain()
        st = c.status(slow["id"])
        assert st["status"] == "partial" and st["error"] == "deadline"
        res = c.result(slow["id"])
        assert res.extra["partial"] is True
        assert c.status(fast["id"])["status"] == "done"
        assert _payload(c.result(fast["id"])) == want


def test_reject_admission_fault(tiny_problem):
    faults = ({"kind": "reject_admission", "tenant": "mallory"},)
    with Client.local(device="cpu", n_workers=1, faults=faults) as c:
        bj = Budget(max_evals=60, seed=0).to_json()
        rej = c.submit(tiny_problem.to_json(), bj, dict(SMALL),
                       tenant="mallory")
        assert rej["error"]["code"] == "injected_rejection"
        ok = c.submit(tiny_problem.to_json(), bj, dict(SMALL),
                      tenant="alice")
        assert ok["status"] == "queued"


def test_subprocess_server_needs_a_card_unless_told_otherwise(tmp_path):
    """``serve`` runs on ``cuda`` unless told otherwise: without a card the
    spawned server refuses to start, and the client sees it die."""
    import torch

    from repro_torch.noc.server import ServerDied

    c = SubprocessClient(str(tmp_path / "journal"), n_workers=1)
    try:
        if torch.cuda.is_available():
            assert c.status()["requests"] == 0
        else:
            with pytest.raises(ServerDied):
                c.status()
    finally:
        c.close()
