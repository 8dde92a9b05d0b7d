"""The 256-tile cell, ``noc256-stage-bfs``: its files are found by name, each
metric it reports has a reader that moves a metric it reports, the delta
path's readers read the program's records and nothing without them, and
the port's evaluator on its delta path agrees with the plain reference at
N = 256."""

import numpy as np
import pytest

from portbench import checks, harness, reference, traffic

CELL = "noc256-stage-bfs"
READERS = ("delta_ms", "rebuild_ms", "host_served_share",
           "delta_fallback_share", "table_miss_share")
#: The metrics of the MOO-STAGE cells that also list this one: the search's
#: time, the evaluator's parts, the surrogate, the kernels and the device.
STAGE = ("surrogate_device_ms", "search_s.stage", "eval_ms.stage",
         "designs_per_call.stage", "outside_eval_ms.stage",
         "k1_roofline.stage", "k4_roofline.stage", "idle_share.stage",
         "phv_score_ms", "ls_keep_ms", "neighbour_ms", "hso_share",
         "surrogate_fit_ms", "meta_search_ms", "run_self_ms.stage",
         "eval_pack_ms.stage", "eval_enqueue_ms.stage",
         "eval_wait_ms.stage", "ls_start_ms")


def test_the_cell_reads_its_configuration_and_mix():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1
    assert cell.config["name"] == "noc-spec256"
    assert cell.config["system"] == {
        "nx": 8, "ny": 8, "n_layers": 4, "n_cpu": 32, "n_llc": 64,
        "n_gpu": 160, "router_stages": 3, "max_hops": 48}
    assert cell.config["reduced"] == []
    assert reference.System(**cell.config["system"]).n_tiles == 256
    assert cell.mix["optimizer"] == "stage" and cell.mix["apps"] == ["BFS"]
    assert (cell.mix["max_evals"], cell.mix["max_call"],
            cell.mix["pool"]) == (1000, 48, 3)


def test_every_metric_of_the_cell_has_a_reader_and_moves_one_it_reports():
    cell = harness.load_cell(CELL)
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {"setup_s", "front_phv", "edp_ratio"}
    assert {m["name"] for m in cell.per_layer} == set(READERS) | set(STAGE)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_reader(m["name"]))
    for m in cell.per_layer:
        assert m["moves"] == "front_phv"
        if m["name"] in READERS:
            assert m["layer"] == "evaluation" and m["workloads"] == [CELL]
        else:
            assert m["workloads"] == ["noc64-stage-bfs", "noc36-batch-avg",
                                      CELL]
    # The cells already there report none of the new metrics.
    for other in ("noc64-stage-bfs", "noc64-nsga2-bfs", "noc36-batch-avg"):
        names = {m["name"] for m in harness.load_cell(other).per_layer}
        assert not names & set(READERS)


def _run(n_evals=(100, 60)):
    searches = [harness.Search(i, 0.0, 1.0, n, []) for i, n in
                enumerate(n_evals)]
    return harness.RunData(None, 1.0, searches, None, "cpu", 256, None)


RECORDS = [
    {"spans": {"noc.run": (1, 2.0, 0.1),
               "noc.eval.delta": (30, 1.5, 0.9),
               "noc.eval.rebuild": (3, 0.6, 0.6)},
     "counts": {"noc.delta.swap": 48, "noc.delta.link": 50,
                "noc.delta.served": 94, "noc.delta.fallback": 1,
                "noc.delta.table_hit": 27, "noc.delta.table_miss": 3}},
    {"spans": {"noc.run": (1, 1.0, 0.1),
               "noc.eval.delta": (20, 0.5, 0.3),
               "noc.eval.rebuild": (1, 0.2, 0.2)},
     "counts": {"noc.delta.swap": 24, "noc.delta.link": 30,
                "noc.delta.served": 54,
                "noc.delta.table_hit": 19, "noc.delta.table_miss": 1}},
]


def test_the_readers_read_the_delta_paths_records(monkeypatch):
    from repro_torch import tracing

    monkeypatch.setattr(tracing, "runs", lambda: list(RECORDS))
    got = {name: harness.load_reader(name)(_run()) for name in READERS}
    assert got["delta_ms"] == pytest.approx(1e3 * (0.9 + 0.3) / 2)
    assert got["rebuild_ms"] == pytest.approx(1e3 * (0.6 + 0.2) / 2)
    assert got["host_served_share"] == pytest.approx(
        100 * (94 + 54) / 160)
    assert got["delta_fallback_share"] == pytest.approx(100 * 1 / 80)
    assert got["table_miss_share"] == pytest.approx(100 * 4 / 50)


def test_the_readers_read_nothing_without_the_delta_path(monkeypatch):
    """The parent's program and a dense search leave no delta span and no
    delta counter: each reader returns None, so the line leaves it out."""
    from repro_torch import tracing

    dense = [{"spans": {"noc.run": (1, 1.0, 0.2),
                        "noc.eval.pack": (5, 0.1, 0.1)},
              "counts": {"noc.phv.hso": 3}}] * 2
    for recs in (dense, [], [dense[0]]):
        monkeypatch.setattr(tracing, "runs", lambda recs=recs: list(recs))
        for name in READERS:
            assert harness.load_reader(name)(_run()) is None, (name, recs)


def test_the_delta_path_agrees_with_the_reference_at_n256():
    """Two spec_large designs, one swap and one link move from the mesh,
    through the port's CPU evaluator with its delta path on (host tables),
    against the plain float64 reference, within the checks' limits."""
    from repro_torch.core.evaluate import Evaluator
    from repro_torch.core.problem import SystemSpec, sample_neighbor_moves

    cell = harness.load_cell(CELL)
    system = reference.System(**cell.config["system"])
    f = traffic.matrix(system, cell.mix)
    spec = SystemSpec(**cell.config["system"])
    ev = Evaluator(spec, f, device="cpu", delta="on")
    mv = sample_neighbor_moves(spec, spec.mesh_design(),
                               np.random.default_rng(5), 1, 1)
    assert len(mv) == 2
    rows = ev.batch_moves(mv)
    assert ev.delta_stats["swap"] == 1 and ev.delta_stats["delta"] == 1
    designs = [mv.materialize(j) for j in range(2)]
    ref_rows, _, valid = reference.objectives(
        system, f, np.stack([d.perm for d in designs]),
        np.stack([d.adj for d in designs]))
    assert valid.all()
    assert checks.rel_gap(rows, ref_rows) <= checks.LIMITS["obj_rel_gap"]


def test_a_traced_tiny_run_of_the_cell_reads_its_span_metrics():
    """The cell's mix on a tiny system, traced on the CPU: every metric of
    the MOO-STAGE cells read from the program's spans and counters reads
    here too (the delta path is off at this size, so its readers do not)."""
    import dataclasses

    from portbench.tests.test_portbench_spans import SPAN_METRICS, TINY_SYSTEM

    cell = harness.load_cell(CELL)
    cell = dataclasses.replace(
        cell, config=dict(cell.config, system=TINY_SYSTEM),
        mix=dict(cell.mix, max_evals=120, pool=2,
                 config={"max_local_steps": 4}))
    out = harness.run_cell(cell, 2 ** 33 + 11, 0.2, True, device="cpu")
    assert out["correct"] is True, out["checks"]
    ours = set(STAGE) & set(SPAN_METRICS)
    assert ours and ours <= set(out["metrics"])
    assert not set(READERS) & set(out["metrics"])
