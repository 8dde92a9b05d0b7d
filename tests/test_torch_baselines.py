"""The port's baselines (AMOSA, NSGA-II, PCBB), its two device twins (the
NSGA-II rank/crowding scorer and the batched PHV scorer) and the agnostic
study, on the CPU against the JAX reference, plus the reference's own
contracts for them (tests/test_search.py, tests/test_noc_api.py,
tests/test_system.py, tests/test_fused.py) held on the port.

Search parity bar: at the same seed and max_evals the port gives the
reference's front (the same designs, rows within 8 f32 ulps) and the same
(n_evals, n_calls). The CPU rows agree with the reference's only to a few
ulps, so a decision whose inputs tie exactly in one package can fall the
other way in the other (a knife-edge). Where a run parts, the test holds
exactly that: both visited the same designs up to the parting, with rows
within 8 ulps, and the port's search replayed on the reference's rows takes
the reference's decisions bit for bit — the same designs in the same
order, the same front, the same accounting (repro_torch.noc.parity)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.noc as ref_noc
from repro.core import PhvContext as RefPhvContext
from repro.core.agnostic import OptimizeBudget as RefOptimizeBudget
from repro.core.agnostic import optimize_for_traffic as ref_optimize
from repro.core.agnostic import run_agnostic_study as ref_study
from repro.core.nsga2 import rank_and_crowding as ref_rank_and_crowding
from repro.core.phv_jnp import hypervolume_with_batch_jnp
from repro_torch.core import CASES, dominates, random_design
from repro_torch.core.agnostic import (OptimizeBudget, optimize_for_traffic,
                                       run_agnostic_study, summarize,
                                       thermal_study)
from repro_torch.core.amosa import amosa
from repro_torch.core.nsga2 import (RANK_BACKENDS, _fast_nondominated_rank,
                                    nsga2, rank_and_crowding,
                                    resolve_rank_backend)
from repro_torch.core.pareto import (PHV_BACKENDS, PhvContext,
                                     hypervolume_with_batch)
from repro_torch.core.pcbb import pcbb
from repro_torch.core.phv_torch import hypervolume_with_batch_torch
from repro_torch.core.problem import spec_tiny
from repro_torch.core.traffic import traffic_matrix
from repro_torch.noc import (Budget, NocProblem, get_optimizer, named_spec,
                             optimizer_names, run)
from repro_torch.noc.parity import EvalLog, first_parting, hold_runs

ROOT = Path(__file__).resolve().parent.parent
#: 8 f32 ulps, relative.
ULPS8 = 8 * 2.0 ** -24

BASELINES = {
    "amosa": None,
    "amosa_adaptive": {"adaptive_block": True},
    "nsga2": None,
    "pcbb": None,
}


@pytest.fixture(scope="module")
def tiny_problem():
    problem = NocProblem(spec=spec_tiny(), traffic="BFS", case="case3")
    ev = problem.evaluator(device="cpu")
    ctx = problem.context(ev)
    return problem, ev, ctx


def _hold_against_reference(name, config, seed, max_evals=300):
    """Run ``name`` in both packages and apply the parity bar; returns the
    parting summary."""
    opt = name.split("_")[0]
    problem = NocProblem(spec=named_spec("tiny"), traffic="BFS")
    ref_problem = ref_noc.NocProblem(spec=ref_noc.named_spec("tiny"),
                                     traffic="BFS")
    res, _, part = hold_runs(
        lambda ev: run(problem, opt, Budget(max_evals=max_evals, seed=seed),
                       config=config, ev=ev),
        lambda: problem.evaluator(device="cpu"),
        lambda ev: ref_noc.run(ref_problem, opt,
                               ref_noc.Budget(max_evals=max_evals, seed=seed),
                               config=config, ev=ev),
        ref_problem.evaluator, ULPS8)
    assert len(res.designs) > 0 and np.isfinite(res.phv())
    return part


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_front_matches_reference(name, seed):
    part = _hold_against_reference(name, BASELINES[name], seed)
    print(f"{name} seed {seed}: {part}")


def test_registry_lists_every_ported_optimizer():
    assert optimizer_names() == ("amosa", "local", "nsga2", "pcbb", "stage",
                                 "stage_batch", "stage_dist")
    assert not get_optimizer("pcbb").native_max_evals
    assert all(get_optimizer(n).native_max_evals
               for n in optimizer_names() if n != "pcbb")
    assert [n for n in optimizer_names()
            if get_optimizer(n).owns_result] == ["stage_dist"]
    for name in ("amosa", "nsga2", "pcbb"):
        ours = get_optimizer(name).config_cls()
        theirs = ref_noc.get_optimizer(name).config_cls()
        assert ours == type(ours)(**{
            k: getattr(theirs, k) for k in ours.__dataclass_fields__})
        assert set(ours.__dataclass_fields__) == set(
            theirs.__dataclass_fields__)


# ------------------------------------------------- the budget fallback (PCBB)
def test_budget_guard_backstops_pcbb(tiny_problem):
    """PCBB has no native max_evals: the guard stops it and the recorder's
    best-so-far Pareto set comes back, as in the reference."""
    problem, ev, ctx = tiny_problem
    cap = ev.n_evals + 40
    res = run(problem, "pcbb", budget=Budget(max_evals=cap, seed=0),
              config=dict(max_expansions=500), ev=ev, ctx=ctx)
    assert res.exhausted
    assert len(res.designs) >= 1
    assert ev.n_evals <= cap + 8
    ref = ref_noc.run(ref_noc.NocProblem(spec=ref_noc.named_spec("tiny"),
                                         traffic="BFS"), "pcbb",
                      budget=ref_noc.Budget(max_evals=40, seed=0),
                      config=dict(max_expansions=500))
    fresh = run(NocProblem(spec=named_spec("tiny"), traffic="BFS"), "pcbb",
                budget=Budget(max_evals=40, seed=0),
                config=dict(max_expansions=500), device="cpu")
    assert fresh.exhausted and ref.exhausted
    assert (fresh.n_evals, fresh.n_calls) == (ref.n_evals, ref.n_calls)
    assert len(fresh.designs) == len(ref.designs) >= 1


def test_budget_guard_max_calls(tiny_problem):
    problem, ev, ctx = tiny_problem
    res = run(problem, "nsga2",
              budget=Budget(max_calls=ev.n_calls + 2, seed=0),
              config=dict(pop_size=8, generations=10), ev=ev, ctx=ctx)
    assert res.exhausted and res.n_calls <= 3


# ------------------------------------------------ contracts of the drivers
def _nondominated(objs, obj_idx):
    sub = objs[:, list(obj_idx)]
    for i in range(sub.shape[0]):
        for j in range(sub.shape[0]):
            if i != j:
                assert not dominates(sub[i], sub[j])


def test_amosa_archive_nondominated(tiny_problem):
    problem, ev, ctx = tiny_problem
    spec = problem.spec
    arch = amosa(spec, ev, ctx, spec.mesh_design(), seed=0, t_max=0.5,
                 t_min=0.05, alpha=0.7, iters_per_temp=10,
                 max_evals=ev.n_evals + 200)
    _nondominated(arch.objs, ctx.obj_idx)
    arch = amosa(spec, ev, ctx, spec.mesh_design(), seed=3, t_max=0.5,
                 t_min=0.05, alpha=0.7, iters_per_temp=10,
                 max_evals=ev.n_evals + 150, block_size=8)
    _nondominated(arch.objs, ctx.obj_idx)


def test_amosa_adaptive_block_budget_pinned(tiny_problem):
    problem, ev, ctx = tiny_problem
    spec = problem.spec
    b = ev.n_evals + 120
    arch = amosa(spec, ev, ctx, spec.mesh_design(), seed=3, t_max=1.0,
                 t_min=1e-6, alpha=0.7, iters_per_temp=10, max_evals=b,
                 adaptive_block=True, block_max=16)
    assert ev.n_evals == b
    _nondominated(arch.objs, ctx.obj_idx)


def test_amosa_default_block_unchanged(tiny_problem):
    problem, ev, ctx = tiny_problem
    spec = problem.spec
    b = ev.n_evals + 60
    a1 = amosa(spec, ev, ctx, spec.mesh_design(), seed=11, t_max=0.5,
               t_min=1e-6, alpha=0.7, iters_per_temp=10, max_evals=b)
    assert ev.n_evals == b
    b2 = ev.n_evals + 60
    a2 = amosa(spec, ev, ctx, spec.mesh_design(), seed=11, t_max=0.5,
               t_min=1e-6, alpha=0.7, iters_per_temp=10, max_evals=b2,
               block_size=1, adaptive_block=False)
    assert np.array_equal(np.sort(a1.objs, axis=0), np.sort(a2.objs, axis=0))
    with pytest.raises(ValueError, match="block_size"):
        amosa(spec, ev, ctx, spec.mesh_design(), block_size=0)


def test_nsga2_runs_and_improves(tiny_problem):
    problem, ev, ctx = tiny_problem
    mesh = problem.spec.mesh_design()
    ps = nsga2(problem.spec, ev, ctx, mesh, seed=0, pop_size=8,
               generations=5)
    assert len(ps.designs) >= 1
    assert ctx.phv(ps.objs) >= ctx.phv(ev(mesh)[None]) - 1e-9


def test_pcbb_finds_design_better_or_equal_mesh(tiny_problem):
    problem, ev, ctx = tiny_problem
    res = pcbb(problem.spec, ev, ctx, seed=0, max_expansions=500)
    mesh_scal = float(ctx.normalize(ev(problem.spec.mesh_design())).mean())
    assert float(ctx.normalize(res.best_objs).mean()) <= mesh_scal + 1e-9
    assert res.nodes_expanded > 0


def test_run_callback_streams_telemetry(tiny_problem):
    problem, ev, ctx = tiny_problem
    events = []
    run(problem, "amosa", budget=Budget(max_evals=ev.n_evals + 20, seed=1),
        config=dict(iters_per_temp=4), callback=events.append, ev=ev,
        ctx=ctx)
    evs = [e["n_evals"] for e in events]
    assert evs and evs == sorted(evs)
    assert all({"n_evals", "n_calls", "best_edp", "wall_s"} <= set(e)
               for e in events)


# ------------------------------------------------------- the rank twin
def test_nondominated_rank_duplicate_rows_deterministic():
    objs = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 1.0], [0.0, 2.0]])
    rank = _fast_nondominated_rank(objs)
    assert rank[0] < rank[1] < rank[2]
    for backend in ("numpy", "device"):
        r, _ = rank_and_crowding(objs, backend, device="cpu")
        assert np.array_equal(r, rank)


def test_rank_twin_matches_numpy_and_reference_jnp():
    """The bar of the reference's jnp twin: ranks equal, finite crowding
    within rtol 1e-5 / atol 1e-6, the same infinities — here against numpy
    and against the reference's jnp twin."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(2, 65))
        m = int(rng.integers(1, 5))
        objs = rng.integers(0, 4, size=(n, m)).astype(np.float64)
        r_np, c_np = rank_and_crowding(objs, "numpy")
        r_d, c_d = rank_and_crowding(objs, "device", device="cpu")
        r_j, c_j = ref_rank_and_crowding(objs, "jnp")
        assert c_d.dtype == np.float64
        for r, c in ((r_np, c_np), (r_j, c_j)):
            assert np.array_equal(r, r_d)
            fin = np.isfinite(c)
            assert np.array_equal(fin, np.isfinite(c_d))
            np.testing.assert_allclose(c_d[fin], c[fin], rtol=1e-5,
                                       atol=1e-6)


def test_rank_backend_names():
    assert RANK_BACKENDS == ("auto", "numpy", "device")
    assert resolve_rank_backend("auto", "cpu") == "numpy"
    assert resolve_rank_backend("device", "cpu") == "device"
    with pytest.raises(ValueError, match="'device'"):
        resolve_rank_backend("jnp", "cpu")
    with pytest.raises(ValueError, match="'device'"):
        run(NocProblem(spec=named_spec("tiny")), "nsga2",
            Budget(max_evals=40), config={"rank_backend": "jnp"},
            device="cpu")


def test_nsga2_device_rank_backend_runs_on_the_cpu(tiny_problem):
    problem, ev, ctx = tiny_problem
    ps = nsga2(problem.spec, ev, ctx, problem.spec.mesh_design(), seed=0,
               pop_size=8, generations=3, rank_backend="device")
    assert len(ps.designs) >= 1
    _nondominated(ps.objs, ctx.obj_idx)


# -------------------------------------------------------- the PHV twin
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_phv_twin_conforms(m):
    """The twin against the host f64 HSO and the reference's jnp twin at
    m = 1..4, with duplicates and candidates beyond ref."""
    rng = np.random.default_rng(m)
    ref = np.full(m, 1.6)
    pts = rng.uniform(0.2, 1.5, size=(9, m))
    pts = np.vstack([pts, pts[:2]])
    cands = rng.uniform(0.1, 1.9, size=(13, m))
    got = hypervolume_with_batch_torch(pts, cands, ref, device="cpu")
    np.testing.assert_allclose(got, hypervolume_with_batch(pts, cands, ref),
                               rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(got,
                               hypervolume_with_batch_jnp(pts, cands, ref),
                               rtol=3e-5, atol=3e-6)


def test_phv_twin_empty_set():
    ref = np.full(3, 1.6)
    cands = np.random.default_rng(0).uniform(0.2, 1.5, size=(5, 3))
    got = hypervolume_with_batch_torch(np.zeros((0, 3)), cands, ref,
                                       device="cpu")
    np.testing.assert_allclose(
        got, hypervolume_with_batch(np.zeros((0, 3)), cands, ref),
        rtol=3e-5, atol=3e-6)


def test_phv_context_backend_knob():
    spec = spec_tiny()
    problem = NocProblem(spec=named_spec("tiny"), traffic="BFS")
    ev = problem.evaluator(device="cpu")
    mesh_objs = ev(spec.mesh_design())
    assert PHV_BACKENDS == ("host", "device")
    with pytest.raises(ValueError, match="'device'"):
        PhvContext(mesh_objs, CASES["case3"], phv_backend="jnp")
    with pytest.raises(ValueError):
        PhvContext(mesh_objs, CASES["case3"], phv_backend="cuda")
    ctx_h = problem.context(ev)
    ctx_d = problem.context(ev, phv_backend="device")
    assert ctx_d.device == torch.device("cpu")
    rng = np.random.default_rng(1)
    objs = ev.batch([random_design(spec, rng) for _ in range(6)])
    want = ctx_h.phv_with_batch(objs[:4], objs[4:])
    np.testing.assert_allclose(ctx_d.phv_with_batch(objs[:4], objs[4:]),
                               want, rtol=3e-5, atol=3e-6)
    ref_ctx = RefPhvContext(mesh_objs, CASES["case3"], phv_backend="jnp")
    np.testing.assert_allclose(ctx_d.phv_with_batch(objs[:4], objs[4:]),
                               ref_ctx.phv_with_batch(objs[:4], objs[4:]),
                               rtol=3e-5, atol=3e-6)
    assert ctx_d.phv(objs) == ctx_h.phv(objs)


# -------------------------------------------------------- agnostic study
SMALL_STUDY = dict(iters_max=2, n_swaps=8, n_link_moves=8,
                   max_local_steps=10)


def test_agnostic_study_matches_reference():
    spec = spec_tiny()
    apps = ("BFS", "HS", "NW")
    got = run_agnostic_study(spec, apps, "case3",
                             OptimizeBudget(**SMALL_STUDY), device="cpu")
    want = ref_study(spec, apps, "case3", RefOptimizeBudget(**SMALL_STUDY))
    assert got["table"].shape == (3, 3)
    np.testing.assert_allclose(np.diag(got["table"]), 1.0, atol=1e-9)
    for a in apps:
        assert got["designs"][a].key() == want["designs"][a].key()
        assert got["avg_designs"][a].key() == want["avg_designs"][a].key()
    # Ratios of EDPs whose rows agree to a few ulps.
    np.testing.assert_allclose(got["table"], want["table"], rtol=2 * ULPS8,
                               atol=0)
    np.testing.assert_allclose(got["avg_row"], want["avg_row"],
                               rtol=2 * ULPS8, atol=0)
    s = summarize(got)
    assert s["app_specific_avg_degradation"] < 1.0
    assert s["avg_noc_degradation"] < 1.0


def test_optimize_for_traffic_case4_matches_reference():
    spec = spec_tiny()
    f = traffic_matrix(spec, "PF")
    budget = dict(iters_max=2, max_local_steps=8)
    d, objs, ev = optimize_for_traffic(spec, f, "case4",
                                       OptimizeBudget(**budget), device="cpu")
    rd, robjs, _ = ref_optimize(spec, f, "case4", RefOptimizeBudget(**budget))
    assert d.key() == rd.key()
    np.testing.assert_allclose(objs, robjs, rtol=ULPS8, atol=0)
    assert objs[4] <= ev(spec.mesh_design())[4]


def test_thermal_study_reports_peak_temperature():
    from repro.core.objectives import make_consts as ref_make_consts
    from repro.core.objectives import \
        peak_temperature_celsius as ref_peak
    from repro_torch.core.objectives import (make_consts,
                                             peak_temperature_celsius)

    spec = spec_tiny()
    out = thermal_study(spec, "BFS", OptimizeBudget(iters_max=1,
                                                    max_local_steps=4),
                        device="cpu")
    assert set(out) == {"case3", "case4", "case5"}
    rng = np.random.default_rng(0)
    for d in [out[c]["design"] for c in out] + [random_design(spec, rng)]:
        assert peak_temperature_celsius(make_consts(spec, "cpu"), d.perm) \
            == ref_peak(ref_make_consts(spec), d.perm)
    assert all(np.isfinite(out[c]["peak_celsius"]) for c in out)


# -------------------------------------------------------------------- CLI
def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.noc", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_cli_compare_and_agnostic(tmp_path):
    out = tmp_path / "cmp.json"
    proc = _cli("compare", "--spec", "tiny", "--app", "BFS",
                "--optimizers", "amosa,nsga2,pcbb", "--max-evals", "60",
                "--set", "nsga2={'pop_size': 8}", "--device", "cpu",
                "--out", str(out))
    assert proc.returncode == 0, proc.stderr
    for name in ("amosa", "nsga2", "pcbb"):
        assert f"{name}: pareto=" in proc.stdout
    assert "best final EDP" in proc.stdout and out.exists()
    proc = _cli("agnostic", "--spec", "tiny", "--apps", "BFS,HS",
                "--iters", "1", "--moves", "4", "--local-steps", "3",
                "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "normalized EDP" in proc.stdout and "AVG NoC" in proc.stdout
    proc = _cli("compare", "--spec", "tiny", "--optimizers", "amosa",
                "--set", "nsga2={}", "--device", "cpu")
    assert proc.returncode != 0 and "match none" in proc.stderr


# ------------------------------------------------------------ the parity bar
def test_hold_runs_refuses_a_changed_decision():
    """The replay separates a knife-edge from a fault: a search that takes
    other decisions on the same rows (here another seed) fails the bar."""
    problem = NocProblem(spec=named_spec("tiny"), traffic="BFS")
    ref_problem = ref_noc.NocProblem(spec=ref_noc.named_spec("tiny"),
                                     traffic="BFS")
    with pytest.raises(AssertionError, match="replay"):
        hold_runs(
            lambda ev: run(problem, "amosa", Budget(max_evals=60, seed=1),
                           ev=ev),
            lambda: problem.evaluator(device="cpu"),
            lambda ev: ref_noc.run(ref_problem, "amosa",
                                   ref_noc.Budget(max_evals=60, seed=0),
                                   ev=ev),
            ref_problem.evaluator, ULPS8)


def test_first_parting_of_one_run_against_itself():
    problem = NocProblem(spec=named_spec("tiny"), traffic="BFS")
    logs = []
    for _ in range(2):
        logs.append(EvalLog(problem.evaluator(device="cpu")))
        run(problem, "nsga2", Budget(max_evals=60, seed=0),
            config=dict(pop_size=8), ev=logs[-1])
    part = first_parting(*logs)
    assert part == {"step": len(logs[0].keys), "evals": (len(logs[0].keys),
                                                          len(logs[1].keys)),
                    "row_rtol": 0.0, "flips": 0, "margin": 0.0}
    assert len(logs[0].keys) >= 60
