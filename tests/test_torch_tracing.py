"""The port's spans and counters (``repro_torch.tracing``).

Off, a span is one shared no-op and nothing is recorded; under
``recording()`` a search through ``repro_torch.noc.run`` leaves one record
whose spans nest (self ≤ total, the children inside the root) and whose
PHV counters agree; under ``torch.profiler`` every span of the record is a
``noc.*`` CPU range with the same calls and, summed, the same time; and
no way of tracing changes a search's result. The LLM side's ranges
(``moe.*``, ``train.optimizer``) are spans too."""

import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core.problem import spec_tiny
from repro_torch.models import moe
from repro_torch.noc import Budget, NocProblem, run

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

SEARCHES = {
    "stage": ({"max_local_steps": 4}, 200, 3),
    "nsga2": ({"pop_size": 8, "generations": 5}, 200, 3),
    "stage_batch": ({"n_starts": 2, "max_local_steps": 4}, 400, 5),
}
EVAL = {"noc.eval.pack", "noc.eval.enqueue", "noc.eval.read"}
LOCAL = {"noc.ls.start", "noc.ls.sample", "noc.ls.score", "noc.ls.keep",
         "noc.surrogate.fit", "noc.surrogate.meta"}
SPANS = {
    "stage": {tracing.ROOT} | LOCAL | EVAL,
    "nsga2": {tracing.ROOT, "noc.nsga2.rank", "noc.nsga2.vary"} | EVAL,
    "stage_batch": {tracing.ROOT} | LOCAL | EVAL,
}


def _search(optimizer):
    cfg, max_evals, seed = SEARCHES[optimizer]
    problem = NocProblem(spec=spec_tiny(), traffic="BFS", case="case3")
    return run(problem, optimizer, Budget(max_evals=max_evals, seed=seed),
               cfg, device="cpu")


def _new_records(before):
    """The records made since ``before`` was read."""
    old = {id(r) for r in before}
    return [r for r in tracing.runs() if id(r) not in old]


# ------------------------------------------------------------------- off
def test_off_a_span_is_the_shared_no_op_and_nothing_is_recorded(
        monkeypatch):
    entered = []
    monkeypatch.setattr(tracing, "_Range", entered.append)
    n = len(tracing.runs())
    a, b = tracing.span(tracing.ROOT), tracing.span("noc.ls.score")
    assert a is b is tracing._OFF
    with a:
        tracing.count("noc.phv.candidates", 5)
        with b:
            pass
    assert len(tracing.runs()) == n and entered == []


def test_off_a_search_records_nothing_and_enters_no_range(monkeypatch):
    entered = []
    monkeypatch.setattr(tracing, "_Range", entered.append)
    n = len(tracing.runs())
    _search("stage")
    assert len(tracing.runs()) == n and entered == []


def test_no_record_function_outside_the_tracing_module():
    found = [str(p.relative_to(SRC)) for p in SRC.rglob("*.py")
             if p.name != "tracing.py"
             and re.search(r"record_function|RecordFunction", p.read_text())]
    assert found == []


# ----------------------------------------------------------- recording()
@pytest.mark.parametrize("optimizer", sorted(SEARCHES))
def test_a_search_under_recording_leaves_one_record(optimizer):
    before = tracing.runs()
    with tracing.recording():
        res = _search(optimizer)
    recs = _new_records(before)
    assert len(recs) == 1
    spans, counts = recs[0]["spans"], recs[0]["counts"]
    assert set(spans) == SPANS[optimizer]
    calls, total, self_s = spans[tracing.ROOT]
    assert calls == 1
    children = sum(v[1] for k, v in spans.items() if k != tracing.ROOT)
    assert children <= total
    # The root's self time is the root's total less its children's.
    assert 0.0 <= self_s <= total - children + 1e-3
    for name, (c, t, s) in spans.items():
        assert c >= 1 and 0.0 <= s <= t + 1e-12, name
    # Every evaluator call packs, enqueues and reads once.
    assert spans["noc.eval.enqueue"][0] == spans["noc.eval.read"][0] \
        == res.n_calls
    if optimizer == "nsga2":
        assert counts == {}
        assert spans["noc.nsga2.rank"][0] == 2 * spans["noc.nsga2.vary"][0]
    else:
        assert 0 <= counts["noc.phv.hso"] <= counts["noc.phv.candidates"]
        assert counts["noc.phv.candidates"] > 0
        assert spans["noc.ls.score"][0] >= spans["noc.ls.keep"][0]


def test_spans_outside_a_run_add_to_no_record():
    before = tracing.runs()
    with tracing.recording():
        with tracing.span("noc.ls.score"):
            tracing.count("noc.phv.hso", 3)
    assert len(tracing.runs()) == len(before)


def test_a_nested_run_adds_to_the_outer_record():
    before = tracing.runs()
    with tracing.recording():
        with tracing.span(tracing.ROOT):
            with tracing.span(tracing.ROOT):
                tracing.count("noc.phv.hso", 2)
            tracing.count("noc.phv.hso", 1)
    recs = _new_records(before)
    assert len(recs) == 1
    assert recs[0]["spans"][tracing.ROOT][0] == 2
    assert recs[0]["counts"] == {"noc.phv.hso": 3}


def test_a_span_in_another_thread_adds_to_its_own_threads_record():
    before = tracing.runs()

    def other():
        with tracing.span("noc.ls.keep"):
            tracing.count("noc.phv.hso", 7)

    with tracing.recording():
        with tracing.span(tracing.ROOT):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    recs = _new_records(before)
    assert len(recs) == 1
    assert set(recs[0]["spans"]) == {tracing.ROOT}
    assert recs[0]["counts"] == {}


def test_runs_keeps_the_newest_records():
    with tracing.recording():
        for _ in range(tracing.MAX_RUNS + 3):
            with tracing.span(tracing.ROOT):
                pass
    recs = tracing.runs()
    assert len(recs) == tracing.MAX_RUNS
    assert all(set(r["spans"]) == {tracing.ROOT} for r in recs[-3:])


def test_a_span_left_by_an_exception_still_closes_its_record():
    before = tracing.runs()
    with tracing.recording():
        with pytest.raises(KeyError):
            with tracing.span(tracing.ROOT):
                with tracing.span("noc.ls.keep"):
                    raise KeyError("x")
        with tracing.span("noc.ls.keep"):
            pass                          # no record is open any more
    recs = _new_records(before)
    assert len(recs) == 1
    assert recs[0]["spans"]["noc.ls.keep"][0] == 1
    assert tracing._state.stack == [] and tracing._state.rec is None


# ------------------------------------------------------------ the profiler
def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            c, d = ranges.get(e.name(), (0, 0))
            ranges[e.name()] = (c + 1, d + e.duration_ns())
    return out, ranges


@pytest.mark.parametrize("optimizer", ["stage", "nsga2"])
def test_under_the_profiler_every_span_is_a_range_on_its_clock(optimizer):
    before = tracing.runs()
    _, ranges = _profiled(lambda: _search(optimizer))
    recs = _new_records(before)
    assert len(recs) == 1
    for name, (calls, total, _) in recs[0]["spans"].items():
        assert name in ranges, name
        n, ns = ranges[name]
        assert n == calls, name
        assert abs(ns / 1e9 - total) <= max(0.05 * total, 50e-6), \
            (name, ns / 1e9, total)


@pytest.mark.parametrize("optimizer", sorted(SEARCHES))
def test_tracing_changes_no_result(optimizer):
    off = _search(optimizer)
    with tracing.recording():
        rec = _search(optimizer)
    prof, _ = _profiled(lambda: _search(optimizer))
    for r in (rec, prof):
        assert (r.n_evals, r.n_calls) == (off.n_evals, off.n_calls)
        np.testing.assert_array_equal(r.objs, off.objs)
        assert [d.key() for d in r.designs] == [d.key() for d in off.designs]
        assert r.phv() == off.phv()


# -------------------------------------------------------- the LLM's spans
def _moe_call():
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True).scaled(
        compute_dtype=torch.float32)
    p = moe.init_moe_layer(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    return lambda: moe.moe_ffn(cfg, p, x)


def test_the_moe_ranges_show_under_the_profiler_only(monkeypatch):
    call = _moe_call()
    (y, aux), ranges = _profiled(call)
    for part in ("route", "dispatch", "experts", "combine"):
        assert ranges.get(f"moe.{part}", (0, 0))[0] == 1, part
    entered = []
    monkeypatch.setattr(tracing, "_Range", entered.append)
    y_off, aux_off = call()
    assert entered == []
    torch.testing.assert_close(y_off, y, rtol=0, atol=0)
    torch.testing.assert_close(aux_off, aux, rtol=0, atol=0)
