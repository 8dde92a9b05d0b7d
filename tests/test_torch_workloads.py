"""The port's workload layer (model-derived NoC traffic) against the
reference's: the same traffic matrices bit for bit, the same mapping, the
same NocProblem canonical form, and the trace link report (K4's original
caller, here on the CPU through the walk's plain version) within rtol 1e-6
of the reference's. Also the reference's own contracts
(tests/test_workloads.py) on the port. The two server tests there wait for
the port of the service."""

import json

import numpy as np
import pytest

import repro.noc as ref_noc
import repro.workloads as ref_wl
from repro_torch.core.problem import random_design, spec_16, spec_64, spec_tiny
from repro_torch.core.traffic import TrafficValidationError
from repro_torch.noc import Budget, NocProblem, named_spec, run
from repro_torch.workloads import (LLM_STUDY_SCENARIOS, PHASE_APP_NAMES,
                                   PHASE_INTENSITY, PHASES, WORKLOADS,
                                   derive_mesh, link_walk_inputs,
                                   normalize_model_traffic, parse_scenario,
                                   phase_weighted_edp, place_model,
                                   scenario_matrix, trace_for,
                                   trace_link_report)
from repro_torch.workloads.mapping import WorkloadMesh

SMALL = dict(iters_max=1, n_swaps=4, n_link_moves=4, max_local_steps=5)


# ------------------------------------------------------- against the reference
def test_scenario_names_equal_reference():
    assert PHASE_APP_NAMES == ref_wl.PHASE_APP_NAMES
    assert PHASES == ref_wl.PHASES
    assert PHASE_INTENSITY == ref_wl.PHASE_INTENSITY
    assert LLM_STUDY_SCENARIOS == ref_wl.LLM_STUDY_SCENARIOS


@pytest.mark.parametrize("spec_fn", [spec_tiny, spec_16, spec_64])
def test_every_scenario_matrix_equals_reference_bits(spec_fn):
    spec = spec_fn()
    for name in PHASE_APP_NAMES:
        arch, phase = parse_scenario(name)
        np.testing.assert_array_equal(
            scenario_matrix(spec, arch, phase),
            ref_wl.scenario_matrix(spec, arch, phase), err_msg=name)


def test_mapping_equals_reference():
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config

    for spec in (spec_64(), spec_16(), spec_tiny()):
        for arch in ("yi-6b", "qwen3-moe-30b-a3b", "zamba2-2.7b"):
            mesh = derive_mesh(get_config(arch), spec.n_gpu)
            ref_mesh = ref_wl.derive_mesh(ref_get_config(arch), spec.n_gpu)
            assert (mesh.data, mesh.model) == (ref_mesh.data, ref_mesh.model)
            mp = place_model(spec, mesh)
            ref_mp = ref_wl.place_model(spec, ref_mesh)
            np.testing.assert_array_equal(mp.gpu_ids, ref_mp.gpu_ids)
            np.testing.assert_array_equal(mp.home_llc, ref_mp.home_llc)
            assert mp.master_cpu == ref_mp.master_cpu


@pytest.mark.parametrize("traffic", [
    {"model": "yi-6b"},
    {"model": "yi-6b", "phase": "serve.decode"},
    {"mesh": [1, 5], "phase": "serve.decode", "model": "yi-6b"},
    {"model": "qwen3-moe-30b-a3b", "phase": "train.bwd"},
])
def test_model_problem_json_equals_reference(traffic):
    p = NocProblem(spec=spec_tiny(), traffic=dict(traffic))
    ref = ref_noc.NocProblem(spec=ref_noc.named_spec("tiny"),
                             traffic=dict(traffic))
    assert json.dumps(p.to_json(), sort_keys=True) == json.dumps(
        ref.to_json(), sort_keys=True)
    back = NocProblem.from_json(json.loads(json.dumps(ref.to_json())))
    assert back == p and hash(back) == hash(p)
    np.testing.assert_array_equal(p.traffic_matrix(), ref.traffic_matrix())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_trace_link_report_matches_reference(workload):
    spec = spec_16()
    rng = np.random.default_rng(4)
    for design in (spec.mesh_design(), random_design(spec, rng)):
        trace = trace_for("yi-6b", workload)
        got = trace_link_report(spec, design, trace, device="cpu")
        want = ref_wl.trace_link_report(spec, design, ref_wl.trace_for(
            "yi-6b", workload))
        np.testing.assert_allclose(got["util"], want["util"], rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(got["visits"], want["visits"],
                                   rtol=1e-6, atol=0)
        # The peak link: the reference's peak value, at the reference's link
        # or at one that ties with it within the rounding of the utils (the
        # mesh has symmetric links whose utils are equal).
        (a, b), peak = got["max_link"]
        assert peak == pytest.approx(want["max_link"][1], rel=1e-6)
        assert want["util"][a, b] == pytest.approx(want["max_link"][1],
                                                   rel=1e-6)
        assert got["mean"] == pytest.approx(want["mean"], rel=1e-6)
        assert got["std"] == pytest.approx(want["std"], rel=1e-6)


def test_link_walk_inputs_one_walk_per_phase():
    spec = spec_tiny()
    trace = trace_for("yi-6b", "training")
    consts, nh, phases = link_walk_inputs(spec, spec.mesh_design(), trace,
                                          device="cpu")
    assert nh.shape == (1, spec.n_tiles, spec.n_tiles)
    assert [p.name for p, _ in phases] == [p.name for p in trace.phases]
    for _, f in phases:
        assert f.shape == nh.shape and float(f[0].diagonal().abs().sum()) == 0


def test_phase_weighted_edp_equals_reference():
    spec = spec_tiny()
    design = random_design(spec, np.random.default_rng(2))
    got = phase_weighted_edp(spec, design,
                             trace_for("qwen3-moe-30b-a3b", "serving"),
                             device="cpu")
    want = ref_wl.phase_weighted_edp(
        spec, design, ref_wl.trace_for("qwen3-moe-30b-a3b", "serving"))
    assert got["weights"] == want["weights"]
    for p in want["per_phase"]:
        assert got["per_phase"][p] == pytest.approx(want["per_phase"][p],
                                                    rel=1e-6)


def test_model_traffic_run_equals_reference():
    traffic = {"model": "yi-6b", "phase": "serve.decode"}
    res = run(NocProblem(spec=named_spec("tiny"), traffic=traffic), "stage",
              budget=Budget(max_evals=60, seed=0), config=dict(SMALL),
              device="cpu")
    ref = ref_noc.run(ref_noc.NocProblem(spec=ref_noc.named_spec("tiny"),
                                         traffic=traffic), "stage",
                      budget=ref_noc.Budget(max_evals=60, seed=0),
                      config=dict(SMALL))
    assert [d.key() for d in res.designs] == [d.key() for d in ref.designs]
    np.testing.assert_allclose(res.objs, ref.objs, rtol=1e-5, atol=0)
    assert (res.n_evals, res.n_calls) == (ref.n_evals, ref.n_calls)
    assert res.problem == ref.problem


# ----------------------------------------------- the reference's contracts
@pytest.mark.parametrize("scenario", LLM_STUDY_SCENARIOS)
def test_generator_invariants(scenario):
    spec = spec_64()
    arch, phase = parse_scenario(scenario)
    f = scenario_matrix(spec, arch, phase)
    assert f.shape == (spec.n_tiles, spec.n_tiles)
    assert np.all(np.isfinite(f)) and np.all(f >= 0)
    np.testing.assert_allclose(np.diag(f), 0.0)
    np.testing.assert_allclose(f.sum(), PHASE_INTENSITY[phase], rtol=1e-9)
    assert np.array_equal(f, scenario_matrix(spec, arch, phase))


def test_study_scenarios_pairwise_distinct():
    spec = spec_64()
    mats = [scenario_matrix(spec, *parse_scenario(s))
            for s in LLM_STUDY_SCENARIOS]
    for i in range(len(mats)):
        for j in range(i + 1, len(mats)):
            a = mats[i] / mats[i].sum()
            b = mats[j] / mats[j].sum()
            assert np.abs(a - b).sum() > 1e-3


def _class_shares(spec, f):
    c, m = spec.n_cpu, spec.n_llc
    bounds = [(0, c), (c, c + m), (c + m, spec.n_tiles)]
    names = ("cpu", "llc", "gpu")
    tot = f.sum()
    return {(names[i], names[j]): f[a:b, p:q].sum() / tot
            for i, (a, b) in enumerate(bounds)
            for j, (p, q) in enumerate(bounds)}


def test_phase_structure_signatures():
    spec = spec_64()
    dense = _class_shares(spec, scenario_matrix(spec, "yi-6b", "train.fwd"))
    moe = _class_shares(
        spec, scenario_matrix(spec, "qwen3-moe-30b-a3b", "train.fwd"))
    decode = _class_shares(
        spec, scenario_matrix(spec, "qwen3-moe-30b-a3b", "serve.decode"))
    assert moe["gpu", "gpu"] > dense["gpu", "gpu"] > 0.5
    assert decode["llc", "gpu"] > 0.5
    assert decode["llc", "gpu"] > dense["llc", "gpu"]
    assert decode["llc", "gpu"] > moe["llc", "gpu"]


def test_place_model_rejects_non_tiling_mesh():
    with pytest.raises(ValueError):
        place_model(spec_64(), WorkloadMesh(data=3, model=7))


def test_model_traffic_normalizes_and_hashes_stably():
    spec = spec_tiny()
    p = NocProblem(spec=spec, traffic={"model": "yi-6b"})
    assert p.traffic == {"model": "yi-6b", "phase": "train.fwd",
                         "mesh": (1, 5)}
    base = NocProblem(spec=spec, traffic={"model": "yi-6b",
                                          "phase": "serve.decode"})
    spelled = NocProblem(spec=spec, traffic={"mesh": [1, 5],
                                             "phase": "serve.decode",
                                             "model": "yi-6b"})
    assert base == spelled and hash(base) == hash(spelled)
    assert base != NocProblem(spec=spec, traffic={"model": "yi-6b",
                                                  "phase": "serve.prefill"})


def test_model_traffic_rejects_bad_specs():
    spec = spec_tiny()
    for bad in (
        {"model": "not-a-model"},
        {"model": "yi-6b", "phase": "train.nope"},
        {"model": "yi-6b", "mesh": [2, 2]},
        {"model": "yi-6b", "mesh": [1, 5, 1]},
        {"model": "yi-6b", "unexpected": 1},
        {"phase": "train.fwd"},
    ):
        with pytest.raises(TrafficValidationError):
            NocProblem(spec=spec, traffic=bad)
    with pytest.raises(TrafficValidationError):
        normalize_model_traffic(spec, {"model": "yi-6b", "mesh": [0, 5]})


def test_trace_link_report_peaks_on_a_real_link():
    spec = spec_tiny()
    rep = trace_link_report(spec, spec.mesh_design(),
                            trace_for("yi-6b", "training"), device="cpu")
    (a, b), peak = rep["max_link"]
    assert a != b and peak > 0
    assert np.all(np.isfinite(rep["util"]))
    np.testing.assert_allclose(rep["util"], rep["util"].T, atol=1e-9)
    assert rep["mean"] >= 0 and rep["std"] >= 0


def test_cli_model_traffic_run(capsys):
    from repro_torch.noc import cli

    rc = cli.main([
        "run", "--spec", "tiny", "--traffic", "model:yi-6b:serve.decode",
        "--max-evals", "60", "--seed", "0", "--device", "cpu",
        "--set", "iters_max=1", "--set", "n_swaps=4",
        "--set", "n_link_moves=4", "--set", "max_local_steps=5",
    ])
    assert rc == 0
    assert "pareto=" in capsys.readouterr().out
    assert cli.parse_traffic_arg("model:yi-6b:serve.decode") == {
        "model": "yi-6b", "phase": "serve.decode"}
    assert cli.parse_traffic_arg("model:yi-6b") == {"model": "yi-6b"}
    assert cli.parse_traffic_arg("BFS") == "BFS"
