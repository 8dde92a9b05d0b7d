"""MOO-STAGE end to end: the port on the CPU against the JAX reference.

At equal seeds and budgets the port visits the same designs as the
reference: the same Pareto front (design keys), objective rows within
rtol 1e-5, the same eval/call accounting. RunResult JSON is shared by the
two packages."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.noc as ref_noc
from repro.core import Evaluator as RefEvaluator
from repro.core import PhvContext as RefPhvContext
from repro.core.stage import moo_stage as ref_moo_stage
from repro_torch.core.evaluate import Evaluator
from repro_torch.core.objectives import CASES
from repro_torch.core.pareto import PhvContext
from repro_torch.core.problem import spec_tiny
from repro_torch.core.stage import moo_stage
from repro_torch.core.traffic import traffic_matrix
from repro_torch.noc import Budget, NocProblem, RunResult, named_spec, run

ROOT = Path(__file__).resolve().parent.parent


def _same_front(a_designs, a_objs, b_designs, b_objs):
    assert [d.key() for d in a_designs] == [d.key() for d in b_designs]
    np.testing.assert_allclose(a_objs, b_objs, rtol=1e-5, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moo_stage_front_matches_reference(seed):
    spec = spec_tiny()
    f = traffic_matrix(spec, "BFS")
    mesh = spec.mesh_design()
    ev = Evaluator(spec, f, device="cpu")
    res = moo_stage(spec, ev, PhvContext(ev(mesh), CASES["case5"]), mesh,
                    seed=seed, max_evals=300)
    rev = RefEvaluator(spec, f)
    rres = ref_moo_stage(spec, rev, RefPhvContext(rev(mesh), CASES["case5"]),
                         mesh, seed=seed, max_evals=300)
    assert res.n_local_searches == rres.n_local_searches
    _same_front(res.global_set.designs, res.global_set.objs,
                rres.global_set.designs, rres.global_set.objs)
    assert (ev.n_evals, ev.n_calls) == (rev.n_evals, rev.n_calls)


@pytest.mark.parametrize("optimizer,config", [
    ("stage", {"max_local_steps": 6, "meta_backend": "host"}),
    ("stage_batch", {"n_starts": 2, "max_local_steps": 6}),
    ("local", {"n_starts": 2}),
])
def test_registry_runs_match_reference(optimizer, config):
    budget = dict(max_evals=250, seed=1)
    res = run(NocProblem(spec=named_spec("tiny"), traffic="BP", case="case3"),
              optimizer, budget=Budget(**budget), config=config, device="cpu")
    rres = ref_noc.run(ref_noc.NocProblem(spec=ref_noc.named_spec("tiny"),
                                          traffic="BP", case="case3"),
                       optimizer, budget=ref_noc.Budget(**budget),
                       config=config)
    _same_front(res.designs, res.objs, rres.designs, rres.objs)
    assert (res.n_evals, res.n_calls) == (rres.n_evals, rres.n_calls)


def test_runresult_json_round_trips_between_packages(tmp_path):
    res = run(NocProblem(spec=named_spec("tiny"), traffic="BFS"), "stage",
              budget=Budget(max_evals=120, seed=0),
              config={"iters_max": 2, "max_local_steps": 5}, device="cpu")
    path = tmp_path / "port.json"
    res.save(path)
    ref_loaded = ref_noc.RunResult.load(path)
    assert [d.key() for d in ref_loaded.designs] == [d.key()
                                                    for d in res.designs]
    assert np.array_equal(ref_loaded.objs, res.objs)
    back_path = tmp_path / "back.json"
    ref_loaded.save(back_path)
    back = RunResult.load(back_path)
    assert json.dumps(back.to_json(), sort_keys=True) == json.dumps(
        res.to_json(), sort_keys=True)
    problem = ref_noc.NocProblem.from_json(ref_loaded.problem)
    assert problem.case == "case3" and problem.traffic == "BFS"


def test_problem_knobs_and_unported_traffic():
    spec = named_spec("tiny")
    assert "device" not in json.dumps(NocProblem(spec=spec).to_json())
    with pytest.raises(ValueError, match="'auto'"):
        NocProblem(spec=spec, backend="jnp")
    with pytest.raises(ValueError, match="'auto'"):
        NocProblem(spec=spec, forest_backend="pallas")
    with pytest.raises(NotImplementedError):
        NocProblem(spec=spec, traffic={"model": "gemma3-1b"})
    with pytest.raises(ValueError, match="'fused'"):
        run(NocProblem(spec=spec), "stage",
            config={"meta_backend": "fused-pallas"}, device="cpu")


def test_cli_smoke_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.noc", "run", "--smoke",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "smoke ok" in proc.stdout
