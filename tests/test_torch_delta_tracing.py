"""The evaluator's delta path under tracing (``repro_torch.tracing``).

A search whose evaluator serves neighbourhoods from host tables leaves one
record with the span ``noc.eval.delta`` and, inside it, ``noc.eval.rebuild``
(every full recomputation of a design's tables), and counters equal to the
evaluator's ``delta_stats``; with the delta path off neither span opens and
nothing is counted; no way of tracing changes the search's result."""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core.problem import spec_36
from repro_torch.noc import Budget, NocProblem, run

DELTA_SPANS = {"noc.eval.delta", "noc.eval.rebuild"}
COUNTERS = ("noc.delta.swap", "noc.delta.link", "noc.delta.fallback",
            "noc.delta.table_hit", "noc.delta.table_miss")


def delta_counts(stats):
    """The counters ``COUNTERS`` as ``delta_stats`` gives them: link moves
    count with their fallbacks."""
    return (stats["swap"], stats["delta"] + stats["fallback"],
            stats["fallback"], stats["table_hits"], stats["table_misses"])


def _search(delta):
    """A MOO-STAGE search on spec_36 through ``noc.run`` on the CPU, its
    evaluator's delta path ``delta``; returns the result and the
    evaluator."""
    problem = NocProblem(spec=spec_36(), traffic="BFS")
    ev = problem.evaluator(device="cpu", delta=delta)
    res = run(problem, "stage", Budget(max_evals=300, seed=4),
              {"max_local_steps": 4}, ev=ev, device="cpu")
    return res, ev


def _recorded(delta):
    with tracing.recording():
        res, ev = _search(delta)
    return res, ev, tracing.runs()[-1]


def test_the_delta_path_leaves_its_spans_nested_and_its_counters():
    _, ev, rec = _recorded("on")
    spans = rec["spans"]
    assert DELTA_SPANS <= set(spans)
    for name in DELTA_SPANS:
        calls, total, self_s = spans[name]
        assert calls >= 1 and total >= self_s >= 0.0
    # The rebuilds open inside the delta span: its total holds them.
    assert spans["noc.eval.delta"][1] >= spans["noc.eval.rebuild"][1]
    assert spans[tracing.ROOT][1] >= spans["noc.eval.delta"][1]
    stats = ev.delta_stats
    assert stats["swap"] > 0 and stats["delta"] > 0
    assert stats["table_misses"] >= 1
    counts = rec["counts"]
    assert tuple(counts.get(c, 0) for c in COUNTERS) == delta_counts(stats)
    # Each rebuild is a cache miss or a fallback.
    assert spans["noc.eval.rebuild"][0] == \
        stats["table_misses"] + stats["fallback"]
    # The candidates served from host tables: every swap, and the link
    # moves less those whose tables an accepted move built for the cache.
    served = counts["noc.delta.served"]
    assert stats["swap"] < served <= stats["swap"] + counts["noc.delta.link"]
    assert served <= ev.n_evals


def test_with_the_delta_path_off_nothing_of_it_is_traced():
    _, ev, rec = _recorded("off")
    assert not DELTA_SPANS & set(rec["spans"])
    assert not [c for c in rec["counts"] if c.startswith("noc.delta.")]
    assert ev.delta_stats == dict.fromkeys(ev.delta_stats, 0)


@pytest.mark.parametrize("delta", ["on", "off"])
def test_tracing_the_delta_path_changes_no_result(delta):
    off, _ = _search(delta)
    rec, _, _ = _recorded(delta)
    with profile(activities=[ProfilerActivity.CPU]):
        prof, _ = _search(delta)
    for r in (rec, prof):
        assert (r.n_evals, r.n_calls) == (off.n_evals, off.n_calls)
        np.testing.assert_array_equal(r.objs, off.objs)
        assert [d.key() for d in r.designs] == [d.key() for d in off.designs]
        assert r.phv() == off.phv()


def test_delta_on_and_off_give_the_same_search():
    on, ev_on = _search("on")
    off, _ = _search("off")
    assert ev_on.delta_stats["swap"] > 0
    assert (on.n_evals, on.n_calls) == (off.n_evals, off.n_calls)
    np.testing.assert_array_equal(on.objs, off.objs)
    assert [d.key() for d in on.designs] == [d.key() for d in off.designs]
