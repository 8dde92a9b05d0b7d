"""run_self_ms: host milliseconds of a search that no span of the program
names: the root span's self time, the mean over the window's searches (the
program's span ``noc.run``)."""

from portbench.spans import SELF, span_ms


def read(run):
    return span_ms(run, "noc.run", SELF)
