"""NSGA-II (Deb et al. [9]) — secondary baseline (the paper cites it as the
canonical GA-based MOO; AMOSA was shown superior in [10], we include both).

Variation operators respect the design space: crossover recombines the two
parents' tile placements (cycle-style repair to stay a permutation) and
takes a random mix of their planar links (repaired to the exact link
budget); mutation applies the paper's neighbor moves. Evaluation is batched
through the Evaluator — a full population is scored per device pass.

Selection scoring (nondominated rank + crowding) is itself array-shaped:
the numpy implementation is the oracle and a twin (``backend="device"``)
computes it in f32 on a device: on a card one kernel launch
(``ops.nsga2_rank``), on the CPU its plain PyTorch version
(``kernels/ref.py::nsga2_rank_ref``: the O(n²·m) dominance tensor, the
front-peeling loop, and the per-objective crowding sweeps as tensor
operations). Duplicate objective rows are tie-broken deterministically by
index (first copy ranks first), which keeps the dominance relation acyclic
— a front always exists and genuinely dominated points can never share a
rank with a dominator."""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from .evaluate import Evaluator
from .local_search import ParetoSet, SearchHistory
from .pareto import PhvContext, crowding_distance
from .problem import (Design, SystemSpec, _triu_pairs, draw_neighbor_moves,
                      sample_neighbors)
from ..tracing import count, span

RANK_BACKENDS = ("auto", "numpy", "device")


def resolve_rank_backend(backend: str | None = None, device=None) -> str:
    """``"auto"`` is ``"device"`` when ``device`` (default ``"cuda"``) is a
    CUDA device and ``"numpy"`` on the CPU."""
    b = backend if backend is not None else "auto"
    if b == "jnp":
        raise ValueError(
            "rank backend 'jnp' is replaced in repro_torch by 'device' (the "
            "PyTorch twin on the evaluator's device)")
    if b not in RANK_BACKENDS:
        raise ValueError(f"backend must be one of {RANK_BACKENDS}, got {b!r}")
    if b == "auto":
        b = "device" if resolve_device(device).type == "cuda" else "numpy"
    return b


def _dominance(objs: np.ndarray):
    """dom[i, j]: i dominates j, with exact-duplicate rows ordered by index
    (the first copy dominates later copies). The relation stays acyclic:
    along any would-be cycle the rows must be equal, and equal rows are
    ordered by strictly increasing index."""
    n = objs.shape[0]
    le = np.all(objs[:, None, :] <= objs[None, :, :], axis=-1)
    lt = np.any(objs[:, None, :] < objs[None, :, :], axis=-1)
    idx = np.arange(n)
    dup = le & ~lt & (idx[:, None] < idx[None, :])
    return (le & lt) | dup


def _fast_nondominated_rank(objs: np.ndarray) -> np.ndarray:
    dom = _dominance(objs)
    n = objs.shape[0]
    n_dom = dom.sum(axis=0)  # how many dominate j
    rank = np.full(n, -1)
    r = 0
    remaining = np.ones(n, dtype=bool)
    while remaining.any():
        front = remaining & (n_dom == 0)
        assert front.any(), "dominance relation must be acyclic"
        rank[front] = r
        n_dom = n_dom - dom[front].sum(axis=0)
        remaining &= ~front
        r += 1
    return rank


#: Pinned host staging for the card's selection calls, one per thread: the
#: objective rows on their way in, then the kernel's (2, n) output.
_staging = threading.local()


def _rank_crowd_card(objs: np.ndarray, dev: torch.device) -> np.ndarray:
    """The selection kernel's (2, n) i32 output for ``objs`` on the card:
    one copy in from pinned memory, one launch, one copy back into it."""
    n, m = objs.shape
    need = n * m + 2 * n
    buf = getattr(_staging, "buf", None)
    if buf is None or buf.numel() < need:
        buf = _staging.buf = torch.empty(max(need, 4096), dtype=torch.int32,
                                         pin_memory=True)
    rows = buf[:n * m].view(torch.float32).view(n, m)
    rows.numpy()[...] = objs
    out = ops.nsga2_rank(rows.to(dev, non_blocking=True))
    host = buf[n * m:need].view(2, n)
    host.copy_(out)
    return host.numpy().copy()


def rank_and_crowding(objs: np.ndarray, backend: str | None = None,
                      device=None):
    """(rank, crowding) for one population on the selected backend;
    ``"device"`` runs the f32 twin on ``device`` (default ``"cuda"``; on a
    card the selection kernel, ``ops.nsga2_rank``) and returns f64
    crowding."""
    with span("noc.nsga2.rank"):
        if resolve_rank_backend(backend, device) == "device":
            dev = resolve_device(device)
            if dev.type == "cuda":
                count("noc.nsga2.rank.kernel")
                out = _rank_crowd_card(objs, dev)
            else:
                out = ops.nsga2_rank(torch.as_tensor(
                    np.asarray(objs, np.float32), device=dev)).numpy()
            return out[0], out[1].view(np.float32).astype(np.float64)
        return _fast_nondominated_rank(objs), crowding_distance(objs)


def _vary(spec: SystemSpec, pop: list[Design], rank: np.ndarray,
          crowd: np.ndarray, rng: np.random.Generator,
          p_mutate: float) -> list[Design]:
    """One generation's ``len(pop)`` children, built in one pass over the
    population's rows: placements (P, N) and planar links as
    upper-triangle rows (P, N(N-1)/2) in ``_triu_pairs`` order. Per child:
    two binary tournaments (lower rank, then larger crowding), crossover,
    and with probability ``p_mutate`` one neighbor move. The generator sees
    the calls of the reference's per-child loop (``_crossover``, then
    ``sample_neighbors(spec, child, rng, 1, 1)`` and a uniform pick) in the
    same order, so the children are that loop's bit for bit; only the
    picked move is applied, on the child's rows."""
    n = spec.n_tiles
    iu0, iu1 = _triu_pairs(n)
    perms = np.stack([d.perm for d in pop])
    links = np.stack([d.adj for d in pop]).reshape(len(pop), n * n)[
        :, iu0 * n + iu1]
    child_perms = np.empty((len(pop), n), np.int32)
    child_links = np.empty((len(pop), iu0.size), bool)
    rk, cw = rank.tolist(), crowd.tolist()

    def tournament():
        i, j = rng.integers(len(pop), size=2)
        if rk[i] < rk[j] or (rk[i] == rk[j] and cw[i] > cw[j]):
            return i
        return j

    for child, row in zip(child_perms, child_links):
        ia, ib = tournament(), tournament()
        # Placement: a random segment of b grafted into a, the rest of a
        # kept in order, so the child stays a permutation.
        lo, hi = sorted(rng.choice(n, size=2, replace=False))
        seg = perms[ib, lo:hi]
        inseg = np.zeros(n, dtype=bool)
        inseg[seg] = True
        rest = perms[ia][~inseg[perms[ia]]]
        child[:lo] = rest[:lo]
        child[lo:hi] = seg
        child[hi:] = rest[lo:]
        # Links: those both parents have, then a shuffled pick of those
        # only one has, up to the link budget.
        np.bitwise_and(links[ia], links[ib], out=row)
        need = spec.n_planar_links - int(np.count_nonzero(row))
        pick = np.flatnonzero(links[ia] ^ links[ib])
        rng.shuffle(pick)
        row[pick[:need]] = True
        if rng.random() < p_mutate:
            swaps, ri, ai = draw_neighbor_moves(spec, child, row, rng, 1, 1)
            if len(swaps) + len(ri):
                j = rng.integers(len(swaps) + len(ri))
                if j < len(swaps):
                    s, t = swaps[j]
                    child[s], child[t] = child[t], child[s]
                else:
                    row[ri[j - len(swaps)]] = False
                    row[ai[j - len(swaps)]] = True
    adj = np.zeros((len(pop), n, n), dtype=bool)
    adj[:, iu0, iu1] = child_links
    adj = adj | adj.transpose(0, 2, 1)
    return [Design(perm=p, adj=a) for p, a in zip(child_perms, adj)]


def nsga2(
    spec: SystemSpec,
    ev: Evaluator,
    ctx: PhvContext,
    d0: Design,
    seed: int = 0,
    *,
    pop_size: int = 32,
    generations: int = 30,
    p_mutate: float = 0.6,
    max_evals: int | None = None,
    history: SearchHistory | None = None,
    rank_backend: str = "auto",
) -> ParetoSet:
    rng = np.random.default_rng(seed)
    history = history or SearchHistory(ev, ctx)
    device = ev.device
    rank_backend = resolve_rank_backend(rank_backend, device)

    pop = [d0]
    while len(pop) < pop_size:
        nb = sample_neighbors(spec, d0, rng, 2, 2)
        pop.append(nb[rng.integers(len(nb))] if nb else d0.copy())
    objs = ev.batch(pop)
    for d, o in zip(pop, objs):
        history.record(ev, d, o)

    for _ in range(generations):
        if max_evals is not None and ev.n_evals >= max_evals:
            break
        sub = objs[:, list(ctx.obj_idx)]
        rank, crowd = rank_and_crowding(sub, rank_backend, device)

        with span("noc.nsga2.vary"):
            children = _vary(spec, pop, rank, crowd, rng, p_mutate)
        child_objs = ev.batch(children)
        for d, o in zip(children, child_objs):
            history.record(ev, d, o)

        # Environmental selection over parents + children.
        union = pop + children
        uobjs = np.vstack([objs, child_objs])
        sub = uobjs[:, list(ctx.obj_idx)]
        rank, crowd = rank_and_crowding(sub, rank_backend, device)
        order = np.lexsort((-crowd, rank))
        keep = order[:pop_size]
        pop = [union[i] for i in keep]
        objs = uobjs[keep]

    return ParetoSet.empty().merged_with(pop, objs, ctx.obj_idx)
