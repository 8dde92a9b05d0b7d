"""surrogate_fit_ms: host milliseconds a search spends featurising
trajectories and fitting the surrogate forest, the mean over the window's
searches (the program's span ``noc.surrogate.fit``)."""

from portbench.spans import TOTAL, span_ms


def read(run):
    return span_ms(run, "noc.surrogate.fit", TOTAL)
