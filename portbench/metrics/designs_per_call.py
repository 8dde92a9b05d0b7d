"""designs_per_call: designs evaluated per device pass of the evaluator
(a call of more than its max_batch designs is cut into several)."""


def read(run):
    passes = [n for s in run.searches for c in s.calls for n in c.chunks]
    return sum(passes) / len(passes) if passes else None
