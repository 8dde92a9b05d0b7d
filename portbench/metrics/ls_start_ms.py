"""ls_start_ms: host milliseconds a search spends starting its local
searches: each chain's working set seeded with the global front and the
start, and its PHV (an HSO over the whole seeded set); self time, the mean
over the window's searches (the program's span ``noc.ls.start``)."""

from portbench.spans import SELF, span_ms


def read(run):
    return span_ms(run, "noc.ls.start", SELF)
