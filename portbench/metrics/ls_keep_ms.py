"""ls_keep_ms: host milliseconds a search spends keeping each chain's accepted
move: materialising it, the working set's merge and crowding thinning with
its PHV, the history's record; self time, the mean over the window's
searches (the program's span ``noc.ls.keep``)."""

from portbench.spans import SELF, span_ms


def read(run):
    return span_ms(run, "noc.ls.keep", SELF)
