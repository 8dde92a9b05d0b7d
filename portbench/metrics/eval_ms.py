"""eval_ms: host milliseconds a search spends inside calls into the
evaluator (each ends in a device sync), the mean over the window's
searches."""


def read(run):
    return 1e3 * sum(c.seconds for s in run.searches for c in s.calls) \
        / len(run.searches)
