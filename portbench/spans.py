"""The program's own spans and counters (``repro_torch.tracing``), read
per search. A traced window's searches are its last records, one a
``repro_torch.noc.run`` call; a program without that module, or with
fewer records than searches, has nothing to read."""

from __future__ import annotations

#: A record's span tuple: (calls, total_s, self_s).
TOTAL, SELF = 1, 2


def records(run) -> list | None:
    """The records of the window's searches, or None."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    n = len(run.searches)
    recs = tracing.runs()
    return recs[-n:] if n and len(recs) >= n else None


def span_ms(run, name: str, part: int) -> float | None:
    """Milliseconds a search of span ``name``'s total or self time, the
    mean over the window's searches."""
    recs = records(run)
    if recs is None:
        return None
    return 1e3 * sum(r["spans"].get(name, (0, 0.0, 0.0))[part]
                     for r in recs) / len(recs)


def counter_ratio(run, num: str, den: str) -> float | None:
    """100 × counter ``num`` ÷ counter ``den`` over the window's searches,
    in percent; None where ``den`` never counted."""
    recs = records(run)
    if recs is None:
        return None
    d = sum(r["counts"].get(den, 0) for r in recs)
    return 100.0 * sum(r["counts"].get(num, 0) for r in recs) / d if d \
        else None
