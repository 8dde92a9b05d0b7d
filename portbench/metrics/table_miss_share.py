"""table_miss_share: of the delta path's lookups of a neighbourhood base's
routing tables in the evaluator's cache, the percent that missed and cost
a full recomputation (the program's counters ``noc.delta.table_miss``
over it plus ``noc.delta.table_hit``), over the window's searches. None
where no lookup was counted."""

from portbench.spans import records

HIT, MISS = "noc.delta.table_hit", "noc.delta.table_miss"


def read(run):
    recs = records(run)
    if recs is None:
        return None
    miss = sum(r["counts"].get(MISS, 0) for r in recs)
    total = miss + sum(r["counts"].get(HIT, 0) for r in recs)
    return 100.0 * miss / total if total else None
