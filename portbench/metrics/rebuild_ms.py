"""rebuild_ms: host milliseconds a search spends on full recomputations of
a design's routing tables in the evaluator's delta path (a table-cache
miss, or a link move whose incremental update gave up), total time; the
mean over the window's searches (the program's span ``noc.eval.rebuild``,
opened inside ``noc.eval.delta``). None where the span never opened."""

from portbench.spans import TOTAL, records

SPAN = "noc.eval.rebuild"


def read(run):
    recs = records(run)
    if recs is None or not any(SPAN in r["spans"] for r in recs):
        return None
    return 1e3 * sum(r["spans"].get(SPAN, (0, 0.0, 0.0))[TOTAL]
                     for r in recs) / len(recs)
