"""outside_eval_ms: host milliseconds of a search outside calls into the
evaluator (the host search, the surrogate's fit and its device passes),
the mean over the window's searches."""


def read(run):
    inside = sum(c.seconds for s in run.searches for c in s.calls)
    return 1e3 * (sum(s.wall_s for s in run.searches) - inside) \
        / len(run.searches)
