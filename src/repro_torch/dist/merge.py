"""Pareto-union merge of worker :class:`~repro_torch.noc.api.RunResult`s.

The coordinator's correctness contract: the merged result
must be a pure function of the *set* of worker results, never of the order
they arrived in — process pools complete out of order, and a merge that
depended on completion order would make distributed runs unreproducible.

Three mechanisms deliver that:

* **Canonical pre-sort** (``ParetoSet.canonical_union``) — all (design,
  objectives) pairs from all inputs are deduplicated and sorted by
  (objective row, design key) before the non-domination mask runs.
  ``pareto_mask`` keeps the *first* of exact-duplicate rows, so without
  the pre-sort the surviving design among tied rows would depend on
  input order.
* **Worker-id-ordered histories** — convergence histories concatenate in
  worker-id order (not arrival order), with per-worker spans recorded in
  ``extra["history_spans"]`` as ``[worker_id, start, stop]`` rows. A
  result that is itself a merge carries its spans through (offset), so
  nested merges flatten associatively.
* **Singleton passthrough** — ``merge_results([r])`` returns ``r``'s
  payload unchanged (idempotence; also what pins the W=1 serial run to
  byte-identical ``stage_batch`` output).

Accounting is summed (``n_evals``/``n_calls``), ``wall_s`` is the max
(workers run concurrently), and ``exhausted`` is the OR — one worker
tripping its shard budget marks the merged run exhausted.

Header fields (``optimizer``/``problem``/``budget``/``config``) are taken
from the lowest-worker-id input (order-independent, like everything
else); the coordinator that called the merge owns them and overwrites
them with the global run's identity.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..core.local_search import ParetoSet
from ..core.pareto import PhvContext
from ..noc.api import RunResult


def _worker_spans(res: RunResult) -> list[list[int]]:
    """History spans of one input: carried through from a previous merge
    if present, else one span covering the whole history, tagged with the
    result's ``extra["worker_id"]``. A multi-input merge REQUIRES the
    tag — falling back to list position would make the merged history
    depend on arrival order, the exact nondeterminism this module
    exists to prevent."""
    spans = res.extra.get("history_spans")
    if spans:
        return [[int(w), int(a), int(b)] for w, a, b in spans]
    if "worker_id" not in res.extra:
        raise ValueError(
            "merge_results inputs must carry extra['worker_id'] (or "
            "history_spans from a previous merge); untagged results would "
            "make the merged history depend on input order")
    return [[int(res.extra["worker_id"]), 0,
             int(np.asarray(res.history).shape[0])]]


def merge_results(results: list[RunResult],
                  ctx: PhvContext | None = None) -> RunResult:
    """Merge worker ``RunResult``s by Pareto union.

    Deterministic in the *set* of inputs: any permutation of ``results``
    yields bit-identical merged designs, objectives, history, and
    accounting. ``ctx`` (optional) recomputes the merged set's PHV into
    ``extra["phv"]``; without it the PHV diagnostic is omitted (workers'
    own PHVs are per-shard, not comparable to the union's).
    """
    if not results:
        raise ValueError("merge_results needs at least one RunResult")
    if len(results) == 1:
        return dataclasses.replace(results[0])

    obj_idx = results[0].obj_idx
    problem0 = json.dumps(results[0].problem, sort_keys=True)
    for r in results[1:]:
        if r.obj_idx != obj_idx:
            raise ValueError(
                f"cannot merge results with different objective subsets: "
                f"{r.obj_idx} vs {obj_idx}")
        if json.dumps(r.problem, sort_keys=True) != problem0:
            raise ValueError("cannot merge results of different problems")

    # ---------------------------------------------------- Pareto union
    # ParetoSet.canonical_union dedups identical (objectives, design)
    # pairs across inputs (merging overlapping results is idempotent) and
    # canonical-sorts before the non-domination mask so its keep-first
    # tie-breaking is order-independent.
    union = ParetoSet.canonical_union(
        [r.pareto_set() for r in results], obj_idx)
    designs, objs = union.designs, union.objs

    # ------------------------------------------ histories, tagged + sorted
    tagged = [(tuple(w for w, _, _ in _worker_spans(r)), r)
              for r in results]
    flat = [w for ws, _ in tagged for w in ws]
    if len(flat) != len(set(flat)):
        raise ValueError(
            f"worker ids must be unique across merged results, got {flat}")
    tagged.sort(key=lambda t: t[0])
    hist_parts: list[np.ndarray] = []
    spans: list[list[int]] = []
    offset = 0
    for _, r in tagged:
        h = np.asarray(r.history, dtype=np.float64).reshape(-1, 4)
        for w, a, b in _worker_spans(r):
            spans.append([w, offset + a, offset + b])
        hist_parts.append(h)
        offset += h.shape[0]
    history = (np.concatenate(hist_parts, axis=0) if hist_parts
               else np.zeros((0, 4)))

    # --------------------------------------------------------- diagnostics
    workers = [
        {"worker_id": w[0], "optimizer": r.optimizer,
         "n_evals": int(r.n_evals), "n_calls": int(r.n_calls),
         "pareto_size": len(r.designs), "exhausted": bool(r.exhausted),
         "phv": float(r.extra.get("phv", float("nan")))}
        for w, r in tagged
    ]
    extra: dict = {"history_spans": spans, "workers": workers}
    if ctx is not None:
        extra["phv"] = ctx.phv(objs)

    # Header fields come from the lowest-worker-id input (not list
    # position — the merge must be a pure function of the input *set*);
    # a coordinator overwrites them with the global run's identity anyway.
    head = tagged[0][1]
    return RunResult(
        optimizer=head.optimizer,
        problem=head.problem,
        budget=head.budget,
        config=head.config,
        obj_idx=obj_idx,
        designs=designs,
        objs=objs,
        n_evals=sum(int(r.n_evals) for r in results),
        n_calls=sum(int(r.n_calls) for r in results),
        wall_s=max(float(r.wall_s) for r in results),
        history=history,
        extra=extra,
        exhausted=any(bool(r.exhausted) for r in results),
    )


def merged_pareto(results: list[RunResult]) -> ParetoSet:
    """The merged Pareto set alone (no accounting) — convenience for
    callers that only need the union front. Pure canonical union: works
    on untagged results too (no history to order)."""
    if not results:
        raise ValueError("merged_pareto needs at least one RunResult")
    return ParetoSet.canonical_union(
        [r.pareto_set() for r in results], results[0].obj_idx)
