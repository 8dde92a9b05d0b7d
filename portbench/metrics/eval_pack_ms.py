"""eval_pack_ms: host milliseconds a search spends packing designs for the
evaluator: materialising neighbourhoods, stacking arrays, the copies to the
device, the mean over the window's searches (the program's span
``noc.eval.pack``)."""

from portbench.spans import TOTAL, span_ms


def read(run):
    return span_ms(run, "noc.eval.pack", TOTAL)
