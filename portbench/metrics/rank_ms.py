"""rank_ms: milliseconds a search spends in NSGA-II's rank and crowding, on
the device twin, the reads included, the mean over the window's searches
(the program's span ``noc.nsga2.rank``)."""

from portbench.spans import TOTAL, span_ms


def read(run):
    return span_ms(run, "noc.nsga2.rank", TOTAL)
