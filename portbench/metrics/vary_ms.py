"""vary_ms: host milliseconds a search spends on NSGA-II's tournaments,
crossover and mutation, the mean over the window's searches (the program's
span ``noc.nsga2.vary``)."""

from portbench.spans import TOTAL, span_ms


def read(run):
    return span_ms(run, "noc.nsga2.vary", TOTAL)
