"""meta_search_ms: host milliseconds a search spends in the meta-search on the
surrogate, its device passes (K3) and their reads included, the mean over
the window's searches (the program's span ``noc.surrogate.meta``)."""

from portbench.spans import TOTAL, span_ms


def read(run):
    return span_ms(run, "noc.surrogate.meta", TOTAL)
