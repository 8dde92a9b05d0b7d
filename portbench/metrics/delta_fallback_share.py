"""delta_fallback_share: of the link moves the evaluator's delta path
served, the percent whose incremental table update gave up and fell back
to a full recomputation (the program's counters ``noc.delta.fallback``
over ``noc.delta.link``), over the window's searches. None where no link
move was counted."""

from portbench.spans import counter_ratio


def read(run):
    return counter_ratio(run, "noc.delta.fallback", "noc.delta.link")
