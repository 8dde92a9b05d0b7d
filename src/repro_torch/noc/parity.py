"""Holding two runs of one search against each other.

Two runs of the same search at the same seed — on the card and on the CPU,
or in this package and in the reference — visit the same designs as long
as every decision they take agrees. Their objective rows agree only to the
rounding of f32 sums taken in different orders, so a decision whose inputs
tie exactly in one run (two equal objective values, two equal PHV scores)
can fall the other way in the other run: a knife-edge. From then on the
runs search different designs, and their fronts differ.

What separates a knife-edge from a fault is a replay: run the search again
on an evaluator that answers every design with the other run's row
(:class:`Replay`). Fed the same numbers, the same decisions must follow —
the same designs in the same order, the same front, the same accounting —
bit for bit (:func:`check_replay`). Any fault in the search's own logic
(an rng stream, a comparison, an order) shows there, whatever the rows.

:class:`EvalLog` wraps an evaluator and records every design it evaluates
with its objective row; :func:`first_parting` says where two logs part,
how far their rows differ before that, and the comparisons between those
rows that fall one way in one run and the other way in the other (their
largest relative gap is the knife-edge's margin). Both work on any
evaluator with the ``batch_aux`` / ``batch_moves`` surface.
"""

from __future__ import annotations

import numpy as np


class EvalLog:
    """Evaluator proxy recording (design key, objective row) of every
    evaluation, in order."""

    def __init__(self, ev):
        self._ev = ev
        self.keys: list[bytes] = []
        self._rows: list[np.ndarray] = []

    @property
    def rows(self) -> np.ndarray:
        return (np.concatenate(self._rows) if self._rows
                else np.zeros((0, 5)))

    def _answer(self, designs, rows: np.ndarray) -> np.ndarray:
        self.keys += [d.key() for d in designs]
        self._rows.append(np.asarray(rows, dtype=np.float64))
        return rows

    def batch_aux(self, designs):
        rows, aux = self._ev.batch_aux(designs)
        if designs:
            rows = self._answer(designs, rows)
        return rows, aux

    def batch(self, designs):
        return self.batch_aux(designs)[0]

    def __call__(self, d):
        return self.batch([d])[0]

    def batch_moves(self, moves):
        ms = moves if isinstance(moves, (list, tuple)) else [moves]
        rows = self._ev.batch_moves(moves)
        designs = [d for m in ms for d in m.materialize_all()]
        return self._answer(designs, rows) if designs else rows

    def edp(self, d) -> float:
        objs, aux = self.batch_aux([d])
        return float(aux["net_lat"][0] * objs[0, 3])

    def __getattr__(self, name: str):
        return getattr(self._ev, name)


class Replay(EvalLog):
    """An :class:`EvalLog` whose evaluator answers every design that
    ``other`` (another run's log) evaluated with ``other``'s row. The
    wrapped evaluator still runs every batch, so its counters and auxiliary
    outputs are its own."""

    def __init__(self, ev, other: EvalLog):
        super().__init__(ev)
        self._other = dict(zip(other.keys, other.rows))

    def _answer(self, designs, rows):
        rows = np.array(rows, dtype=np.float64)
        for i, d in enumerate(designs):
            row = self._other.get(d.key())
            if row is not None:
                rows[i] = row
        return super()._answer(designs, rows)


def first_parting(a: EvalLog, b: EvalLog) -> dict:
    """Compare two logs of one search.

    Returns ``{"step": k, "evals": (len a, len b), "row_rtol": r,
    "flips": n, "margin": m}``: ``k`` is the first evaluation whose design
    differs (the shorter length if one log is a prefix of the other);
    ``r`` the largest relative difference between the two runs' rows of
    the first ``k`` evaluations; ``n`` the number of comparisons between
    two of those rows, in one objective, that tie or order one way in run
    ``a`` and the other way in run ``b``; ``m`` the largest relative gap
    of such a comparison in either run (0 when ``n`` is 0)."""
    n = min(len(a.keys), len(b.keys))
    k = next((i for i in range(n) if a.keys[i] != b.keys[i]), n)
    ra, rb = a.rows[:k], b.rows[:k]
    scale = np.maximum(np.abs(ra), np.abs(rb))
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.where(scale > 0, np.abs(ra - rb) / scale, 0.0)
    flips, margin = 0, 0.0
    # One row per distinct design: a design evaluated twice ties with
    # itself in both runs.
    first = sorted({key: i for i, key in reversed(
        list(enumerate(a.keys[:k])))}.values())
    for j in range(ra.shape[1] if k else 0):
        xa, xb = ra[first, j], rb[first, j]
        flip = np.triu(np.sign(xa[:, None] - xa[None, :])
                       != np.sign(xb[:, None] - xb[None, :]), 1)
        if flip.any():
            flips += int(flip.sum())
            i, i2 = np.nonzero(flip)
            mag = np.maximum.reduce([np.abs(xa[i]), np.abs(xa[i2]),
                                     np.abs(xb[i]), np.abs(xb[i2])])
            gap = np.maximum(np.abs(xa[i] - xa[i2]), np.abs(xb[i] - xb[i2]))
            margin = max(margin, float(np.max(gap / mag)))
    return {"step": k, "evals": (len(a.keys), len(b.keys)),
            "row_rtol": float(rel.max()) if rel.size else 0.0,
            "flips": flips, "margin": margin}


def check_replay(replayed, b, log_r: EvalLog, log_b: EvalLog) -> None:
    """A run replayed on run ``b``'s rows must be ``b``: the same designs
    evaluated in the same order, the same front with the same rows bit for
    bit, the same accounting. Raises AssertionError naming the first
    difference."""
    if log_r.keys != log_b.keys:
        raise AssertionError("replay parts from the run it replays: "
                             f"{first_parting(log_r, log_b)}")
    if [d.key() for d in replayed.designs] != [d.key() for d in b.designs]:
        raise AssertionError("replay ends on another front")
    if not np.array_equal(replayed.objs, b.objs):
        raise AssertionError("replay's front rows are not the run's")
    if (replayed.n_evals, replayed.n_calls) != (b.n_evals, b.n_calls):
        raise AssertionError(
            f"replay's accounting {(replayed.n_evals, replayed.n_calls)} != "
            f"{(b.n_evals, b.n_calls)}")


def hold_runs(run_a, make_ev_a, run_b, make_ev_b, rtol: float):
    """Hold run ``a`` against run ``b`` of one search: ``run_x(ev)`` runs it
    on evaluator ``ev`` and returns its RunResult; ``make_ev_x()`` makes a
    fresh evaluator. Passes when both give the same front (designs in
    order, rows within ``rtol``) and the same ``(n_evals, n_calls)``; where
    they part, when the rows before the parting agree within ``rtol`` and
    ``a`` replayed on ``b``'s rows is ``b`` bit for bit
    (:func:`check_replay`). Raises AssertionError otherwise. Returns
    ``(a, b, summary)``, the summary being :func:`first_parting`'s with
    ``"parted"``."""
    log_a = EvalLog(make_ev_a())
    a = run_a(log_a)
    log_b = EvalLog(make_ev_b())
    b = run_b(log_b)
    part = first_parting(log_a, log_b)
    if ([d.key() for d in a.designs] == [d.key() for d in b.designs]
            and (a.n_evals, a.n_calls) == (b.n_evals, b.n_calls)
            and np.allclose(a.objs, b.objs, rtol=rtol, atol=0)):
        return a, b, dict(part, parted=False)
    if part["row_rtol"] > rtol:
        raise AssertionError(f"rows beyond rtol {rtol} before the runs "
                             f"part: {part}")
    log_r = Replay(make_ev_a(), log_b)
    check_replay(run_a(log_r), b, log_r, log_b)
    return a, b, dict(part, parted=True)
