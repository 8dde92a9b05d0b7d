"""The harness: BENCHMARK.json keeps the contract, cells, mixes and metric
readers are found by name (a dummy cell and metric written as new files are
picked up), the comparison rejects the control and a broken timed path,
the trace reduction adds up, and a run refuses to report without a card
or without the program.

Runs here drive the real harness on the CPU (the port's plain kernels) at
small budgets; the one test that needs the card is marked ``cuda``."""

import dataclasses
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import checks, counts, harness, traffic
from portbench.trace import DeviceTrace

REPO = harness.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
H100 = "NVIDIA H100 80GB HBM3"

TINY_CONFIG = {
    "name": "dummy-tiny", "source": "test",
    "system": {"nx": 2, "ny": 2, "n_layers": 2, "n_cpu": 1, "n_llc": 2,
               "n_gpu": 5, "router_stages": 3, "max_hops": 8},
    "case": "case5", "obj_idx": [0, 1, 2, 3, 4], "precision": "float32",
}
TINY_MIX = {"optimizer": "stage", "apps": ["BFS"], "max_evals": 60,
            "max_call": 48, "pool": 3, "config": {"max_local_steps": 4}}


# ------------------------------------------------------------ the contract
def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 << 10
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    rs = BENCH["run_seconds"]
    cells = BENCH["workloads"]
    assert 1 <= rs <= 51
    # A full check of 24 cells fits its time.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["reduced"] == []
        assert c["file"].startswith("portbench/configs/")
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in cells)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in cells}
    assert len({w["name"] for w in cells}) == len(cells)
    for w in cells:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (REPO / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        cell = harness.load_cell(w["name"])
        e2e_here = {m["name"] for m in cell.end_to_end}
        assert {"setup_s"} < e2e_here
        assert cell.per_layer
        # Each per-layer metric moves an end-to-end metric the cell reports.
        assert all(m["moves"] in e2e_here for m in cell.per_layer)


# --------------------------------------------------------- a tiny repo
def _tiny_repo(tmp_path: Path) -> Path:
    """A copy of the benchmark with one more cell, configuration, mix and
    metric, each added as a new file and a new entry."""
    root = tmp_path / "repo"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "portbench"
    (pb / "configs" / "dummy-tiny.json").write_text(json.dumps(TINY_CONFIG))
    (pb / "traffic" / "dummy-stage.json").write_text(json.dumps(TINY_MIX))
    (pb / "metrics" / "dummy_searches.py").write_text(
        "def read(run):\n    return float(len(run.searches))\n")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-tiny", "source": "test",
                             "file": "portbench/configs/dummy-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy-tiny",
                               "traffic": "dummy-stage", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "dummy_searches", "unit": "searches",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny(tmp_path):
    root = _tiny_repo(tmp_path)
    return root, harness.load_cell("dummy.cell", root)


def test_a_cell_and_a_metric_added_as_files_are_picked_up(tiny):
    root, cell = tiny
    assert cell.config["system"] == TINY_CONFIG["system"]
    assert cell.mix["max_evals"] == 60
    assert "dummy_searches" in [m["name"] for m in cell.end_to_end]
    out = harness.run_cell(cell, 2 ** 31 + 99, 0.5, False, device="cpu",
                           repo=root)
    assert out["correct"] is True and out["failed"] == 0
    assert out["metrics"]["dummy_searches"]["value"] == out["attempted"] >= 1
    assert set(out["metrics"]) == {"setup_s", "front_phv", "edp_ratio",
                                   "dummy_searches"}
    assert list(out)[-1] == "checks"
    # The cells already there do not report the new metric.
    assert "dummy_searches" not in [
        m["name"] for m in harness.load_cell("noc64-stage-bfs",
                                             root).end_to_end]


def test_a_traced_run_reads_the_per_layer_metrics(tiny):
    root, cell = tiny
    cell = dataclasses.replace(cell, per_layer=BENCH["per_layer"] + [
        {"name": "dummy_searches", "unit": "searches"}])
    out = harness.run_cell(cell, 5, 0.5, True, device="cpu", repo=root)
    assert out["correct"] is True
    m = out["metrics"]
    # The CPU launches no kernel: the device readers find nothing to read.
    assert {"eval_ms", "designs_per_call", "outside_eval_ms",
            "dummy_searches"} <= set(m)
    assert not {"k1_roofline", "k4_roofline", "surrogate_device_ms"} & set(m)
    assert 1 <= m["designs_per_call"]["value"] <= 48
    # The MOO-STAGE cells read the same numbers under their own names.
    for name in ("eval_ms", "designs_per_call", "outside_eval_ms"):
        assert m[name + ".stage"] == m[name]
    assert m["search_s.stage"]["unit"] == "s"
    assert m["search_s.stage"]["value"] * out["attempted"] > \
        m["eval_ms"]["value"] * out["attempted"] / 1e3 > 0
    assert out["device"]["window_s"] > 0 and "breakdown" in out


# ------------------------------------------------ correct must come out false
def _broken(kind):
    """Evaluator.batch_aux with one fault planted where rows are made."""
    from repro_torch.core.evaluate import Evaluator

    clean = Evaluator.batch_aux
    last = []

    def batch_aux(self, designs):
        rows, aux = clean(self, designs)
        n = rows.shape[0]
        if kind == "state_unchanged" and last:
            rows = np.resize(last[-1], rows.shape)   # the previous call's
        elif kind == "half_batch" and n > 1:
            rows = np.resize(rows[:(n + 1) // 2], rows.shape)
        elif kind == "answer_altered":
            rows = rows.copy()
            rows[:, 3] *= 1.0 + 1e-3
        last.append(rows)
        return rows, aux

    return batch_aux


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, kind):
    from repro_torch.core.evaluate import Evaluator

    root, cell = tiny
    monkeypatch.setattr(Evaluator, "batch_aux", _broken(kind))
    out = harness.run_cell(cell, 17, 0.5, False, device="cpu", repo=root)
    assert out["correct"] is False
    assert out["failed"] >= 1
    gap = out["checks"]["answer_rel_gap"]
    assert gap["value"] > gap["limit"]


def test_the_control_in_the_programs_place_is_not_correct(tiny):
    _, cell = tiny
    prog = harness.Program(cell, "cpu")
    _, outputs = prog.window(23, 0.5, False)
    args = (prog.system, prog.f, cell.config["obj_idx"],
            harness.budget_limit(cell.mix), outputs)
    assert checks.judge(*args).correct
    ctl = checks.judge(*args, control=True)
    assert not ctl.correct
    assert ctl.checks["obj_rel_gap"]["value"] > 1e-3
    assert ctl.checks["answer_rel_gap"]["value"] > 1e-3


def test_a_search_past_its_budget_is_not_correct(tiny):
    _, cell = tiny
    prog = harness.Program(cell, "cpu")
    _, outputs = prog.window(29, 0.2, False)
    outputs[0].n_evals = harness.budget_limit(cell.mix)
    v = checks.judge(prog.system, prog.f, cell.config["obj_idx"],
                     harness.budget_limit(cell.mix), outputs)
    assert v.checks["over_budget"]["value"] == 1 and not v.correct


@pytest.mark.parametrize("name,max_evals,timed", [
    ("noc64-stage-bfs", 100, set()),
    ("noc64-nsga2-bfs", 100, {"search_s"}),
    ("noc36-batch-avg", 300, set())])
def test_each_cell_runs_on_the_cpu_at_a_small_budget(name, max_evals, timed):
    cell = harness.load_cell(name)
    cell = dataclasses.replace(cell, mix=dict(cell.mix, max_evals=max_evals))
    out = harness.run_cell(cell, 3 * 10 ** 12, 0.1, False, device="cpu")
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"setup_s", "front_phv",
                                   "edp_ratio"} | timed
    assert 0 < out["metrics"]["edp_ratio"]["value"] <= 1.0 + 1e-9


# ------------------------------------------------------------- the trace
def _trace():
    ops = [("apsp_kernel(float const*)", 100, 110),
           ("walk_tree_kernel", 105, 125),           # overlaps the first
           ("walk_util_kernel", 300, 310),
           ("Memcpy DtoH", 500, 505)]
    spans = [("portbench.search", 0, 1000),
             ("portbench.eval.batch", 90, 320),
             ("portbench.search", 1100, 1200)]
    return DeviceTrace.within(ops, spans, 0, 1200)


def test_the_trace_reduction_adds_up():
    t = _trace()
    assert t.busy_s == pytest.approx((25 + 10 + 5) / 1e9)
    assert t.window_s == pytest.approx(1200 / 1e9)
    assert t.kernel_time("walk_") == (pytest.approx(30 / 1e9), 2)
    assert sum(b - a for a, b in t.idle_gaps()) == 1200 - 40
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps["eval.batch"] == pytest.approx((230 - 25 - 10) / 1e9)
    assert gaps["between searches"] == pytest.approx(100 / 1e9)
    assert gaps["search outside eval"] == pytest.approx(
        (90 + 680 - 5 + 100) / 1e9)
    ops = dict(t.breakdown()["device_ops"])
    assert ops["walk_tree_kernel"] == pytest.approx(20 / 1e9)


def _run_data(card=H100, trace=None, n=64, chunks=(48, 48, 1)):
    calls = [harness.Call("batch", b, (b,), 1e-3, True) for b in chunks]
    s = harness.Search(1, 0.0, 0.5, sum(chunks), calls)
    return harness.RunData(None, 1.0, [s, s], None, card, n,
                           trace or _trace())


def test_roofline_readers_count_bytes_by_call_shape():
    k1 = harness.load_reader("k1_roofline")
    k4 = harness.load_reader("k4_roofline")
    data = _run_data()
    least = 2 * sum(counts.apsp_bytes(b, 64) for b in (48, 48, 1)) / 3.35e12
    assert k1(data) == pytest.approx(100 * least / (10 / 1e9))
    least4 = 2 * sum(counts.walk_bytes(b, 64) for b in (48, 48, 1)) / 3.35e12
    assert k4(data) == pytest.approx(100 * least4 / (30 / 1e9))
    assert k1(_run_data(card="some other card")) is None
    empty = DeviceTrace.within([], [("portbench.search", 0, 10)], 0, 10)
    assert k1(_run_data(trace=empty)) is None
    assert harness.load_reader("surrogate_device_ms")(data) is None
    assert harness.load_reader("idle_share")(data) == pytest.approx(
        100 * (1 - 40 / 1200))
    assert harness.load_reader("designs_per_call")(data) == pytest.approx(
        97 / 3)


def test_counts_at_the_main_path_shape():
    assert counts.apsp_bytes(48, 64) == 1_572_864
    assert counts.walk_bytes(48, 64) == 4 * (5 * 48 * 64 * 64 + 64 * 64
                                             + 48 * 64 + 48)
    assert counts.least_seconds(3.35e12, H100) == pytest.approx(1.0)
    assert counts.least_seconds(1.0, "a card without peaks") is None


# ------------------------------------------------------- the process
def _run(cwd, *args, timeout=300):
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_a_run_without_a_card_prints_no_result(no_card):
    p = _run(REPO, "--workload", "noc64-stage-bfs", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_a_run_with_only_the_benchmark_files_prints_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, "--workload", "noc64-stage-bfs", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


def test_nothing_the_harness_loads_is_jax_or_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
        "import portbench.reference\n"
        "assert not {m.split('.')[0] for m in sys.modules} & "
        "{'torch', 'repro_torch', 'repro', 'jax'}, 'reference'\n"
        "from portbench import harness, control, checks, traffic, counts\n"
        "import repro_torch.noc, repro_torch.kernels.build\n"
        "for m in harness.json.loads((harness.REPO / 'BENCHMARK.json')"
        ".read_text())['per_layer']:\n"
        "    harness.load_reader(m['name'])\n"
        "bad = {m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'repro'}\n"
        "assert not bad, bad\n")
    p = subprocess.run([sys.executable, "-c", code, str(REPO)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr


@pytest.mark.cuda
def test_a_traced_run_on_the_card(card):
    p = _run(REPO, "--workload", "noc64-stage-bfs", "--seed",
             str(2 ** 31 + 5), "--seconds", "3", "--trace", "1",
             timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0
    assert {"k1_roofline.stage", "k4_roofline.stage", "idle_share.stage",
            "search_s.stage"} <= set(out["metrics"])
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


def test_a_window_runs_whole_passes_over_the_pool(tiny):
    _, cell = tiny
    prog = harness.Program(cell, "cpu")
    searches, outputs = prog.window(41, 0.3, False)
    pool = traffic.pool(cell.mix)
    seeds = [s.seed for s in searches]
    assert len(seeds) % len(pool) == 0 and len(outputs) == len(seeds)
    passes = [seeds[i:i + len(pool)] for i in range(0, len(seeds), len(pool))]
    assert all(sorted(p) == sorted(pool) for p in passes)
    assert seeds[:len(pool)] == [pool[j] for j in traffic.order(41, 0, 3)]
    # The same seed runs the same searches in the same order; each answer
    # sample is drawn from the run's seed.
    again, outs = prog.window(41, 0.0, False)
    assert [s.seed for s in again] == seeds[:len(pool)]
    np.testing.assert_array_equal(outs[0].ans_perms, outputs[0].ans_perms)
