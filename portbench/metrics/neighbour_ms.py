"""neighbour_ms: host milliseconds a search spends sampling each step's
neighbourhoods, in move form, self time, the mean over the window's
searches (the program's span ``noc.ls.sample``)."""

from portbench.spans import SELF, span_ms


def read(run):
    return span_ms(run, "noc.ls.sample", SELF)
