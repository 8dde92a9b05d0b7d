"""host_served_share: of the evaluations the window's searches spent, the
percent whose routing tables came from the host's delta path, a swap's
reuse of its base's tables or a link move's update: the program's counter
``noc.delta.served`` over the searches' evaluation counts. None where it
never counted: the delta path did not run."""

from portbench.spans import records

SERVED = "noc.delta.served"


def read(run):
    recs = records(run)
    if recs is None or not any(SERVED in r["counts"] for r in recs):
        return None
    evals = sum(s.n_evals for s in run.searches)
    if not evals:
        return None
    return 100.0 * sum(r["counts"].get(SERVED, 0) for r in recs) / evals
