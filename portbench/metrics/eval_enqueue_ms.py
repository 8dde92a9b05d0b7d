"""eval_enqueue_ms: host milliseconds a search spends enqueueing the
evaluator's device work (cost, K1, next hops, K4, the objectives' tail),
the mean over the window's searches (the program's span
``noc.eval.enqueue``)."""

from portbench.spans import TOTAL, span_ms


def read(run):
    return span_ms(run, "noc.eval.enqueue", TOTAL)
