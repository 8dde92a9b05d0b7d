"""hso_share: of the candidates the local search scores by PHV, the percent
that were neither covered by the working set nor outside the reference box
and so cost a recursive HSO (the program's counters ``noc.phv.hso`` and
``noc.phv.candidates``), over the window's searches."""

from portbench.spans import counter_ratio


def read(run):
    return counter_ratio(run, "noc.phv.hso", "noc.phv.candidates")
