"""The readers of the program's own spans and counters: a traced CPU run of
each cell, cut to a tiny system and budget, reports every such metric that
lists the cell as a number; a program that keeps no records (or fewer than
the window's searches) gives them nothing to read."""

import dataclasses
import json
import sys
import types

import pytest

from portbench import harness, spans

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
#: The metrics read from the program's spans and counters.
SPAN_METRICS = ("phv_score_ms", "ls_keep_ms", "neighbour_ms", "hso_share",
                "surrogate_fit_ms", "meta_search_ms", "rank_ms", "vary_ms",
                "run_self_ms", "run_self_ms.stage", "eval_pack_ms",
                "eval_pack_ms.stage", "eval_enqueue_ms",
                "eval_enqueue_ms.stage", "eval_wait_ms", "eval_wait_ms.stage",
                "ls_start_ms")
NEW = [m for m in BENCH["per_layer"] if m["name"] in SPAN_METRICS]

TINY_SYSTEM = {"nx": 2, "ny": 2, "n_layers": 2, "n_cpu": 1, "n_llc": 2,
               "n_gpu": 5, "router_stages": 3, "max_hops": 8}
TINY_MIX = {
    "noc64-stage-bfs": {"max_evals": 120, "max_call": 48, "pool": 2,
                        "config": {"max_local_steps": 4}},
    "noc64-nsga2-bfs": {"max_evals": 80, "max_call": 8, "pool": 2,
                        "config": {"pop_size": 8, "generations": 8}},
    "noc36-batch-avg": {"max_evals": 240, "max_call": 96, "pool": 2,
                        "config": {"n_starts": 2, "max_local_steps": 4}},
}


def _tiny(name):
    cell = harness.load_cell(name)
    return dataclasses.replace(
        cell, config=dict(cell.config, system=TINY_SYSTEM),
        mix=dict(cell.mix, **TINY_MIX[name]))


def test_every_cell_lists_the_readers_of_the_programs_spans():
    assert len(NEW) == len(SPAN_METRICS)
    for m in NEW:
        assert m["workloads"], m["name"]
        assert m["source"] in ("program_span", "program_counter")
        assert m["unit"] == ("%" if m["source"] == "program_counter"
                             else "ms")
    listed = {w for m in NEW for w in m["workloads"]}
    assert listed == {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("name", sorted(TINY_MIX))
def test_a_traced_tiny_run_reads_every_span_metric_of_the_cell(name):
    cell = _tiny(name)
    ours = [m["name"] for m in cell.per_layer if m["name"] in SPAN_METRICS]
    assert ours
    out = harness.run_cell(cell, 2 ** 33 + 7, 0.2, True, device="cpu")
    assert out["correct"] is True, out["checks"]
    m = out["metrics"]
    for metric in ours:
        assert metric in m, metric
        assert m[metric]["value"] >= 0.0, metric
    if "hso_share" in m:
        assert m["hso_share"]["value"] <= 100.0
    # The named parts of the evaluator lie inside its calls.
    tail = ".stage" if name != "noc64-nsga2-bfs" else ""
    named = sum(m[f"eval_{p}_ms{tail}"]["value"]
                for p in ("pack", "enqueue", "wait"))
    assert 0.0 < named <= m[f"eval_ms{tail}"]["value"]


def test_no_records_means_nothing_to_read(monkeypatch):
    from repro_torch import tracing

    run = types.SimpleNamespace(searches=[None] * (tracing.MAX_RUNS + 1))
    assert spans.records(run) is None
    assert spans.span_ms(run, "noc.run", spans.SELF) is None
    assert spans.counter_ratio(run, "noc.phv.hso",
                               "noc.phv.candidates") is None
    # A program without the tracing module, as before it had one.
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert spans.records(types.SimpleNamespace(searches=[None])) is None
