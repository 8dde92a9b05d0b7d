"""delta_ms: host milliseconds a search spends building candidates' routing
tables on the host in the evaluator's delta path (cache lookups, swaps'
reuse, link moves' O(N^2) updates, the accepted move's tables), self time,
so without the full rebuilds that ``rebuild_ms`` reads; the mean over the
window's searches (the program's span ``noc.eval.delta``). None where the
span never opened: the delta path did not run."""

from portbench.spans import SELF, records

SPAN = "noc.eval.delta"


def read(run):
    recs = records(run)
    if recs is None or not any(SPAN in r["spans"] for r in recs):
        return None
    return 1e3 * sum(r["spans"].get(SPAN, (0, 0.0, 0.0))[SELF]
                     for r in recs) / len(recs)
