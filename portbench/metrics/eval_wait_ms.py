"""eval_wait_ms: host milliseconds a search spends reading the evaluator's
rows back: the wait for the device and the copies to the host, the mean
over the window's searches (the program's span ``noc.eval.read``)."""

from portbench.spans import TOTAL, span_ms


def read(run):
    return span_ms(run, "noc.eval.read", TOTAL)
