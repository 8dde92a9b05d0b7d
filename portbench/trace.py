"""What a traced window read from ``torch.profiler``: the device's
operations, the benchmark's own host spans, and the sums the per-layer
readers and the result's ``breakdown`` take from them.

The host spans are ``record_function`` ranges that the harness opens:
``portbench.search`` around each search and ``portbench.eval.<method>``
around each call into the evaluator. The profiler puts them and the
device's operations (kernels, copies, sets) on one clock.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

SPAN_PREFIX = "portbench."
SEARCH_SPAN = SPAN_PREFIX + "search"
EVAL_SPAN = SPAN_PREFIX + "eval."


@dataclasses.dataclass
class DeviceTrace:
    """Device operations and host spans inside the traced window, in ns."""

    ops: list        # (name, start_ns, end_ns) of every device operation
    spans: list      # (name, start_ns, end_ns) of the benchmark's spans
    start_ns: int
    end_ns: int

    @classmethod
    def from_profiler(cls, prof) -> "DeviceTrace":
        from torch.autograd import DeviceType

        ops, spans = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start, dur = e.start_ns(), e.duration_ns()
            if name.startswith(SPAN_PREFIX):
                # A record_function range shows on the host and, projected,
                # on the device's timeline: it is no device operation.
                if e.device_type() == DeviceType.CPU:
                    spans.append((name, start, start + dur))
            elif e.device_type() == DeviceType.CUDA and not getattr(
                    e, "is_user_annotation", lambda: False)():
                ops.append((name, start, start + dur))
        searches = [s for s in spans if s[0] == SEARCH_SPAN]
        if not searches:
            raise RuntimeError("the profiler recorded no search span")
        return cls.within(ops, spans, min(s[1] for s in searches),
                          max(s[2] for s in searches))

    @classmethod
    def within(cls, ops, spans, start_ns: int, end_ns: int) -> "DeviceTrace":
        keep = [(n, max(a, start_ns), min(b, end_ns)) for n, a, b in ops
                if b > start_ns and a < end_ns]
        return cls(sorted(keep, key=lambda o: o[1]),
                   sorted(spans, key=lambda s: s[1]), start_ns, end_ns)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals."""
        out = []
        for _, a, b in self.ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_time(self, *substrings: str) -> tuple[float, int]:
        """Seconds and launches of the device operations whose names hold
        any of ``substrings``."""
        rows = [b - a for n, a, b in self.ops
                if any(s in n for s in substrings)]
        return sum(rows) / 1e9, len(rows)

    def idle_gaps(self) -> list:
        """(start, end) of each stretch of the window with no device
        operation running."""
        gaps, t = [], self.start_ns
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end_ns > t:
            gaps.append((t, self.end_ns))
        return gaps

    def host_segments(self) -> list:
        """The window cut into (start, end, label) by what the host was
        doing: inside a call into the evaluator (its method), in a search
        outside one, or between searches. Spans of one kind do not nest."""
        evals = [(a, b, n[len(SPAN_PREFIX):]) for n, a, b in self.spans
                 if n.startswith(EVAL_SPAN)]
        searches = [(a, b) for n, a, b in self.spans if n == SEARCH_SPAN]
        cuts = sorted({self.start_ns, self.end_ns}
                      | {t for a, b, _ in evals for t in (a, b)}
                      | {t for s in searches for t in s})
        cuts = [t for t in cuts if self.start_ns <= t <= self.end_ns]
        e_starts = [e[0] for e in evals]
        s_starts = [s[0] for s in searches]
        out = []
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            i = bisect.bisect_right(e_starts, mid) - 1
            j = bisect.bisect_right(s_starts, mid) - 1
            if i >= 0 and evals[i][1] >= mid:
                label = evals[i][2]
            elif j >= 0 and searches[j][1] >= mid:
                label = "search outside eval"
            else:
                label = "between searches"
            out.append((a, b, label))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's idle
        time by what the host was doing, each summed by name, the largest
        first."""
        by_op = defaultdict(float)
        for n, a, b in self.ops:
            by_op[n] += (b - a) / 1e9
        by_gap = defaultdict(float)
        segs = self.host_segments()
        k = 0
        for a, b in self.idle_gaps():
            while k < len(segs) and segs[k][1] <= a:
                k += 1
            j = k
            while j < len(segs) and segs[j][0] < b:
                lo, hi = max(a, segs[j][0]), min(b, segs[j][1])
                by_gap[segs[j][2]] += (hi - lo) / 1e9
                j += 1
        return {
            "device_ops": [[n, s] for n, s in
                           sorted(by_op.items(), key=lambda r: -r[1])[:top]],
            "idle_gaps": [[n, s] for n, s in
                          sorted(by_gap.items(), key=lambda r: -r[1])[:top]],
        }
