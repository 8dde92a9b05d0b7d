"""phv_score_ms: host milliseconds a search spends scoring the local search's
candidates by PHV (an exclusive-contribution HSO per uncovered candidate)
and taking the best, self time, the mean over the window's searches (the
program's span ``noc.ls.score``)."""

from portbench.spans import SELF, span_ms


def read(run):
    return span_ms(run, "noc.ls.score", SELF)
