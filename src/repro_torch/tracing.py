"""Spans and counters inside the port: what a search spends its host time
on, by name.

Turning it on
-------------
Tracing is on while a ``torch.profiler`` records (``with
torch.profiler.profile(...)``, or between its ``start()`` and ``stop()``)
or inside :func:`recording`, which turns it on without a profiler::

    from repro_torch import tracing
    with tracing.recording():
        res = repro_torch.noc.run(problem, "stage", budget)
    rec = tracing.runs()[-1]
    rec["spans"]["noc.ls.score"]        # (calls, total_s, self_s)

Off, :func:`span` returns one shared no-op context after a flag check,
and :func:`count` returns after the same check: neither calls into the
profiler nor allocates.

What a record holds
-------------------
One record is one search: :func:`repro_torch.noc.run` opens the root span
``noc.run`` and with it a record, and closes both. A record is
``{"spans": {name: (calls, total_s, self_s)}, "counts": {name: n}}``:
each span's number of calls, its host seconds summed over them, and that
less the time of the spans opened inside it (its self time); each
counter's sum. ``runs()`` returns the records, newest last, at most the
last :data:`MAX_RUNS`. A span or counter outside any ``noc.run`` adds to
no record. A span's own bookkeeping is left out of its parent's self time,
so the root's self time is host time no span names.

Clocks
------
Under a profiler each span is also a ``record_function`` range (its fast
form, which makes no operator call), so the profiler stamps it on its own
clock, the one it puts the device's kernels and copies on: its trace
shows the span each launch came from. A record's times are read on the
host's ``time.perf_counter`` inside the range's ends, so they agree with
the range's durations; under a profiler they include the profiler's own
cost per operation inside the span, and under :func:`recording` alone
they do not.

Spans sit at call boundaries; none is opened per candidate, per child,
per tree node or per step of a recursion. State is per thread: a search
records into its own thread's record.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from time import perf_counter

from torch._C._profiler import _RecordFunctionFast as _Range
from torch.autograd import profiler as _profiler

#: The root span; one record per outermost call.
ROOT = "noc.run"
#: Records kept by :func:`runs`.
MAX_RUNS = 4096

_recording = 0                      # open recording() contexts
_recording_lock = threading.Lock()
_runs: collections.deque = collections.deque(maxlen=MAX_RUNS)


class _State(threading.local):
    def __init__(self):
        self.stack: list = []       # open spans, innermost last
        self.rec: dict | None = None


_state = _State()


class _Off:
    """The shared span of tracing switched off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def span(name: str):
    """A context that names the host time inside it ``name`` (see the
    module's docstring); the shared no-op when tracing is off."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open record's counter ``name`` when tracing is on."""
    if not (_recording or _profiler._is_profiler_enabled):
        return
    rec = _state.rec
    if rec is not None:
        counts = rec["counts"]
        counts[name] = counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Tracing on without a profiler, for the block's duration."""
    global _recording
    with _recording_lock:
        _recording += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording -= 1


def runs() -> list:
    """The records of the searches traced so far, newest last."""
    return list(_runs)


class _Span:
    __slots__ = ("name", "opens", "range", "t_in", "t0", "inner")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t_in = perf_counter()
        st = _state
        self.opens = self.name == ROOT and st.rec is None
        if self.opens:
            st.rec = {"spans": {}, "counts": {}}
        self.inner = 0.0
        st.stack.append(self)
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _Range(self.name)
            self.range.__enter__()
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        total = perf_counter() - self.t0
        st = _state
        stack = st.stack
        stack.pop()
        rec = st.rec
        if rec is not None:
            spans = rec["spans"]
            s = spans.get(self.name)
            if s is None:
                spans[self.name] = [1, total, total - self.inner]
            else:
                s[0] += 1
                s[1] += total
                s[2] += total - self.inner
            if self.opens:
                st.rec = None
                _runs.append({"spans": {k: tuple(v) for k, v in spans.items()},
                              "counts": dict(rec["counts"])})
        if stack:
            stack[-1].inner += perf_counter() - self.t_in
        return None
