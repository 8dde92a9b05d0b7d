"""The comparison that decides ``correct``.

Every search of a run's window is judged against the plain reference
(:mod:`portbench.reference`), which recomputes a design's objective row in
float64 from its placement and links and the traffic the benchmark made.
Two kinds of the program's answers are judged: every design of every
returned front, and a sample, drawn from the seed, of the evaluator's
answers during the search (a design and the row returned for it). The
numbers compared, each with its limit:

* ``obj_rel_gap``: the largest |program - reference| / |reference| over
  every objective of every design of every front. The program computes in
  float32; the limit lies between the largest gap of sound runs and the
  smallest of the control, the reference computed in bfloat16 put in the
  program's place (PERF.md gives the readings).
* ``answer_rel_gap``: the same over the sampled answers of the evaluator;
  an invalid design's row must be all-INF on both sides.
* ``phv_rel_gap``: the largest relative gap between a search's own PHV and
  the reference's PHV of the same front (each divided by its own mesh row).
* ``invalid_designs``: front designs that break the configuration's
  guarantees: not a permutation, asymmetric or cross-layer links, a link
  count other than the mesh's, or a path longer than ``max_hops``.
* ``dominated_rows``: rows of a front dominated by, or equal to, another
  row of the same front under the program's own rows.
* ``over_budget``: searches that started a call into the evaluator after
  spending ``max_evals`` evaluations, i.e. that spent ``max_evals`` plus
  the mix's ``max_call`` or more.
* ``empty_fronts``: searches that returned no design.

The last four are counts, exact, with the limit 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import reference

#: Limits, set in PERF.md from the readings of sound runs and the control.
LIMITS = {
    "obj_rel_gap": 1e-4,
    "answer_rel_gap": 1e-4,
    "phv_rel_gap": 1e-4,
    "invalid_designs": 0,
    "dominated_rows": 0,
    "over_budget": 0,
    "empty_fronts": 0,
}


@dataclasses.dataclass
class Output:
    """What one search produced: its front (designs, rows, PHV), the
    evaluations it spent, and the sampled answers of its evaluator."""

    perms: np.ndarray         # (D, N) int, the front's placements
    adjs: np.ndarray          # (D, N, N) bool, the front's links
    rows: np.ndarray          # (D, 5) the program's objective rows
    phv: float
    n_evals: int
    ans_perms: np.ndarray     # (S, N)
    ans_adjs: np.ndarray      # (S, N, N)
    ans_rows: np.ndarray      # (S, 5) the rows the evaluator returned


@dataclasses.dataclass
class Verdict:
    """The judged numbers of a run, and what the reference measured."""

    checks: dict          # name -> {"value": v, "limit": l}
    failed: int           # searches with a number over its limit
    phv: list             # reference PHV of each front
    edp_ratio: list       # least network EDP of each front over the mesh's

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            c["value"] <= c["limit"] for c in self.checks.values())


def rel_gap(prog, ref) -> float:
    """Largest relative gap between two arrays of rows; where either side
    is INF (an invalid design) both must be."""
    prog = np.asarray(prog, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if prog.size == 0:
        return 0.0
    bad_p, bad_r = prog >= reference.INF, ref >= reference.INF
    if not np.isfinite(prog).all() or (bad_p != bad_r).any():
        return float("inf")
    ok = ~bad_r
    if not ok.any():
        return 0.0
    return float((np.abs(prog[ok] - ref[ok])
                  / np.maximum(np.abs(ref[ok]), 1e-300)).max())


def _control(system, f, out: Output, obj_idx, mesh_row_bf16) -> Output:
    """The control put in the program's place: the same designs, with the
    rows and PHV of the reference computed in bfloat16."""
    def rows(perms, adjs):
        return reference.objectives(system, f, perms, adjs,
                                    precision="bfloat16")[0]

    front = rows(out.perms, out.adjs)
    return dataclasses.replace(
        out, rows=front, ans_rows=rows(out.ans_perms, out.ans_adjs),
        phv=reference.front_phv(front, mesh_row_bf16, obj_idx))


def judge(system, f: np.ndarray, obj_idx, budget: int, outputs: list,
          *, control: bool = False) -> Verdict:
    """Judge ``outputs`` (one :class:`Output` a search) against the float64
    reference; a search must spend fewer than ``budget`` evaluations
    (``max_evals + max_call``). With ``control`` the bfloat16 reference
    takes the program's place first."""
    mesh = [a[None] for a in system.mesh()]
    rows64, lat64, _ = reference.objectives(system, f, *mesh)
    mesh_row, mesh_edp = rows64[0], lat64[0] * rows64[0, 3]
    if control:
        mesh16 = reference.objectives(system, f, *mesh,
                                      precision="bfloat16")[0][0]
        outputs = [_control(system, f, o, obj_idx, mesh16) for o in outputs]
    # One reference pass over every distinct front design and sampled
    # answer (a pool's searches repeat pass after pass).
    n = system.n_tiles
    parts = [p for o in outputs for p in ((o.perms, o.adjs),
                                          (o.ans_perms, o.ans_adjs))]
    perms = np.concatenate([p for p, _ in parts] + [np.zeros((0, n), int)])
    adjs = np.concatenate([a for _, a in parts] + [np.zeros((0, n, n), bool)])
    slot: dict = {}
    where = np.array([slot.setdefault(p.tobytes() + np.packbits(a).tobytes(),
                                      len(slot))
                      for p, a in zip(perms, adjs)], int)
    firsts = np.unique(where, return_index=True)[1]
    ref = tuple(a[where] for a in reference.objectives(
        system, f, perms[firsts], adjs[firsts]))
    cuts = np.cumsum([0] + [p.shape[0] for p, _ in parts])
    worst = dict.fromkeys(LIMITS, 0.0)
    failed = 0
    phvs, edps = [], []
    for i, o in enumerate(outputs):
        front, answers = (tuple(a[cuts[j]:cuts[j + 1]] for a in ref)
                          for j in (2 * i, 2 * i + 1))
        nums = judge_search(system, obj_idx, budget, o, front, answers,
                            mesh_row, mesh_edp)
        phvs.append(nums.pop("_phv"))
        edps.append(nums.pop("_edp_ratio"))
        failed += any(v > LIMITS[k] for k, v in nums.items())
        for k, v in nums.items():
            worst[k] = (max(worst[k], v) if k.endswith("gap")
                        else worst[k] + v)
    checks = {k: {"value": worst[k], "limit": LIMITS[k]} for k in LIMITS}
    return Verdict(checks, failed, phvs, edps)


def judge_search(system, obj_idx, budget, o: Output, front, answers,
                 mesh_row, mesh_edp) -> dict:
    """The numbers of one search, given the reference's ``(rows, net_lat,
    valid)`` of its front and of its sampled answers, with its front's
    reference PHV and EDP ratio."""
    d = o.rows.shape[0]
    ref_rows, net_lat, valid = front
    invalid = int((~valid).sum()) + sum(
        bool(system.design_faults(p, a)) for p, a in zip(o.perms, o.adjs))
    rows = np.asarray(o.rows, dtype=np.float64).reshape(d, -1)
    ref_phv = reference.front_phv(ref_rows[valid], mesh_row, obj_idx)
    edp = net_lat[valid] * ref_rows[valid, 3]
    return {
        "obj_rel_gap": rel_gap(rows[valid], ref_rows[valid]),
        "answer_rel_gap": rel_gap(o.ans_rows, answers[0]),
        "phv_rel_gap": rel_gap([o.phv], [ref_phv]) if d else 0.0,
        "invalid_designs": invalid,
        "dominated_rows": int(d - reference.pareto_mask(
            rows[:, list(obj_idx)]).sum()),
        "over_budget": int(o.n_evals >= budget),
        "empty_fronts": int(d == 0),
        "_phv": ref_phv,
        "_edp_ratio": (float(edp.min() / mesh_edp) if edp.size
                       else float("inf")),
    }
