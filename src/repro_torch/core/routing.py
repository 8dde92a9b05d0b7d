"""Routing model: all-pairs shortest paths + deterministic path walking.

As in the reference (``repro.core.routing``): minimum-latency shortest-path
routing with lexicographic tie-breaking, where a hop over link (a, b) costs
``r + d_ab`` (router stages + wire delay). APSP is min-plus matrix squaring,
batched over designs (kernel K1, ``csrc/minplus.cu``); next hops follow the
Bellman condition nh[i,j] = first-index argmin_m cost[i,m] + dist[m,j]
(a torch argmin); and one walk over all N^2 pairs of every design
(kernel K4, ``csrc/walk.cu``) accumulates:

  * per-pair hop count h_ij and wire delay d_ij     (Eq. 1),
  * f-weighted directed link utilization U          (Eq. 2),
  * f-weighted router visit counts                  (Eq. 8).

The device of the tensors decides where this runs: the CUDA kernels for
CUDA tensors, their plain versions for CPU tensors. The routing backend of
the reference is not a choice here: ``backend`` accepts only ``"auto"``.

The host mirrors (numpy) below are exact twins of the device tables and the
substrate of the incremental delta path (Evaluator.batch_moves).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops

INF = 1.0e9

BACKENDS = ("auto",)

#: Largest N served by the one-shot (B, N, N, N) broadcast of next-hop
#: extraction (and of the plain min-plus). Above it the j-blocked path runs
#: instead — bit-equal (argmin over exactly the same f32 sums).
DENSE_NMAX = 256

#: Transient budget for one blocked (N, block, N) broadcast slab.
_BLOCK_BUDGET_BYTES = 128 << 20


def _pow2_block(n: int, budget_bytes: int = _BLOCK_BUDGET_BYTES,
                lo: int = 4, hi: int = 128) -> int:
    """Largest power-of-two block b with n·b·n f32 <= ``budget_bytes``
    (clamped to [lo, hi]) — the k/j block width of the memory-safe paths."""
    b = max(1, budget_bytes // (4 * n * n))
    b = 1 << (b.bit_length() - 1)
    return int(min(hi, max(lo, b)))


def apsp_iters(n_tiles: int) -> int:
    """Min-plus squaring iterations guaranteeing APSP convergence for an
    N-node graph."""
    return math.ceil(math.log2(n_tiles)) + 1


def resolve_backend(backend: str | None = None) -> str:
    """Check the routing ``backend`` knob: only ``"auto"`` (the device of
    the tensors decides) exists in this package."""
    b = backend if backend is not None else "auto"
    if b in ("jnp", "pallas"):
        raise ValueError(
            f"routing backend {b!r} is replaced in repro_torch by 'auto' "
            "(CUDA kernels for CUDA tensors, plain versions on the CPU)")
    if b not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {b!r}")
    return b


def apsp_batched(cost: torch.Tensor, n_iters: int) -> torch.Tensor:
    """(B, N, N) APSP distances of a stack of hop-cost matrices (K1)."""
    return ops.apsp(cost, n_iters)


def next_hop(cost: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """(B, N, N) int32 nh[b, i, j] = first-index argmin_m (cost[b, i, m] +
    dist[b, m, j]), with nh[b, i, i] = i.

    Deterministic single-path routing: ties break toward the lowest slot
    index. Staying put (m == i) is not a candidate hop."""
    bsz, n, _ = cost.shape
    eye = torch.eye(n, dtype=torch.bool, device=cost.device)
    step = torch.where(eye, torch.tensor(INF, dtype=cost.dtype,
                                         device=cost.device), cost)
    if n <= DENSE_NMAX:
        nh = (step[:, :, :, None] + dist[:, None, :, :]).argmin(dim=2)
    else:
        bj = min(n, _pow2_block(n))
        nh = torch.cat([
            (step[:, :, :, None] + dist[:, None, :, j0:j0 + bj]).argmin(dim=2)
            for j0 in range(0, n, bj)], dim=2)
    ids = torch.arange(n, device=cost.device)[:, None].expand(n, n)
    return torch.where(eye, ids, nh).to(torch.int32)


def routing_tables_batched(cost: torch.Tensor, n_iters: int):
    """Batched (dist, next_hop)."""
    dist = apsp_batched(cost, n_iters)
    return dist, next_hop(cost, dist)


def walk_paths(nh: torch.Tensor, link_delay: torch.Tensor, f: torch.Tensor,
               max_hops: int):
    """Walk every (src, dst) pair of every design for up to ``max_hops``
    steps (K4).

    nh (B, N, N) int32 next hops, link_delay (N, N) f32, f (B, N, N) f32
    traffic between SLOTS. Returns (hops, delay, util, visits, all_done):
      hops   (B, N, N) int32 — links on the path i->j
      delay  (B, N, N) — sum of wire delays along the path
      util   (B, N, N) — f-weighted directed link usage  (Eq. 2)
      visits (B, N)    — f-weighted router traversals, destination router
                         included (Eq. 8)
      all_done (B,) bool — every pair reached its destination."""
    hops, delay, util, visits, done = ops.walk(nh, f, link_delay, max_hops)
    return hops, delay, util, visits, done.bool()


# ----------------------------------------------------- host mirrors + deltas
# Exact numpy twins of the device tables, the substrate of incremental
# per-move evaluation (Evaluator.batch_moves). Bit-parity with the device path
# rests on integer exactness: every edge cost is a small integer held in f32
# (router stages + integer wire/TSV delay), so every finite path cost is an
# integer far below 2^24 and every f32 sum/min is exact; unreachable entries
# are exactly INF = 1e9 (itself f32-exact, and 1e9 + small rounds to >= 1e9),
# so *any* correct shortest-path scheme — device min-plus squaring, host
# blocked squaring, or bounded Bellman relaxation — lands on the same bits.


def min_plus_np(a: np.ndarray, b: np.ndarray,
                block_k: int | None = None) -> np.ndarray:
    """(M,N)x(N,N) min-plus product on host, k-blocked, dtype-preserving
    (f32 in -> f32 out, bit-equal to the device formulations; the delta
    path also runs it on the f64 tie-broken tables)."""
    a = np.asarray(a)
    b = np.asarray(b)
    dt = np.result_type(a, b, np.float32)
    m, n = a.shape
    bk = min(n, block_k if block_k is not None else
             _pow2_block(max(int(math.isqrt(m * n)), 1)))
    out = np.full((m, b.shape[1]), INF, dtype=dt)
    for k0 in range(0, n, bk):
        ab = a[:, k0:k0 + bk]                       # (M, bk)
        bb = b[k0:k0 + bk, :]                       # (bk, N)
        np.minimum(out, (ab[:, :, None] + bb[None, :, :]).min(axis=1),
                   out=out)
    return out


def apsp_np(cost: np.ndarray, n_iters: int) -> np.ndarray:
    """Host APSP by blocked min-plus squaring; on f32 input bit-equal to
    :func:`apsp_batched` (dtype-preserving like :func:`min_plus_np`)."""
    d = np.asarray(cost)
    if d.dtype != np.float64:
        d = d.astype(np.float32)
    for _ in range(n_iters):
        d = min_plus_np(d, d)
    return d


def next_hop_np(cost: np.ndarray, dist: np.ndarray,
                rows: np.ndarray | None = None) -> np.ndarray:
    """Host next-hop extraction, j-blocked; bit-equal to :func:`next_hop`
    (numpy argmin and torch argmin share first-index tie-breaking).

    ``rows`` restricts the computation to a subset of source rows (the
    delta path rebuilds only touched rows); the diagonal rule nh[i,i] = i
    is applied for whatever rows are produced."""
    cost = np.asarray(cost, dtype=np.float32)
    dist = np.asarray(dist, dtype=np.float32)
    n = cost.shape[0]
    step = np.where(np.eye(n, dtype=bool), np.float32(INF), cost)
    if rows is not None:
        step = step[rows]
    m = step.shape[0]
    nh = np.empty((m, n), dtype=np.int32)
    bj = min(n, _pow2_block(max(int(math.isqrt(m * n)), 1)))
    for j0 in range(0, n, bj):
        sc = step[:, :, None] + dist[None, :, j0:j0 + bj]  # (m, N, bj)
        nh[:, j0:j0 + bj] = sc.argmin(axis=1).astype(np.int32)
    ridx = np.arange(n, dtype=np.int32) if rows is None \
        else np.asarray(rows, dtype=np.int32)
    nh[np.arange(m), ridx] = ridx   # i == j: stay
    return nh


# Tie-breaking perturbations. Shortest paths on NoC meshes are massively
# degenerate (every monotone route ties), which makes "does some shortest
# path use this edge?" a uselessly large dirty test for incremental updates.
# The delta path therefore carries a SHADOW metric with a deterministic
# per-edge perturbation eps in (0, 2^-12): perturbed shortest paths are
# (almost surely) unique, so the dirty set shrinks to pairs whose UNIQUE
# perturbed path uses the edge — a near-minimal superset of the truly
# changed pairs. The shadow is exact integer arithmetic in disguise: edge
# weights are integers < 2^21 plus eps = r·2^-30 (r < 2^18), so any simple
# path's value needs <= 51 mantissa bits — exact in f64 — and its eps-sum
# stays < 1, so floor(perturbed distance) IS the true f32 distance (a path
# with smaller integer weight wins by >= 1 > any eps-sum).
_EPS_SCALE = 2.0 ** -30
_EPS_BITS = 18


@lru_cache(maxsize=8)
def _tie_eps(n: int) -> np.ndarray:
    """(N, N) f32 symmetric per-edge tie-breakers, a fixed deterministic
    function of the slot-pair (NOT of any design), so delta-updated shadow
    tables stay consistent across arbitrary move chains."""
    rng = np.random.default_rng(0x3D0C ^ n)
    r = rng.integers(1, 1 << _EPS_BITS, size=(n, n)).astype(np.float64)
    eps = np.triu(r * _EPS_SCALE, 1)
    return (eps + eps.T).astype(np.float32)


def _nh_cols_sparse(cost: np.ndarray, dist: np.ndarray,
                    cols: np.ndarray) -> np.ndarray:
    """(N, |cols|) next hops for destination columns ``cols``, computed
    from the directed edge list (O(E·C) instead of the dense O(N²·C)).

    Exact full-argmin semantics: for reachable entries only neighbors can
    win (non-neighbor scores are >= INF after f32 rounding, and INF never
    rounds down), and within-group edge order is (i, m) row-major — the
    same first-index tie-break. Entries whose best neighbor score reaches
    INF (disconnected pairs, where the oracle's argmin can land on a
    non-neighbor through INF-rounding ties) are re-done densely."""
    cost = np.asarray(cost, dtype=np.float32)
    dist = np.asarray(dist, dtype=np.float32)
    n = cost.shape[0]
    cols = np.asarray(cols, dtype=np.int64)
    off = ~np.eye(n, dtype=bool)
    ea, eb = np.nonzero((cost < INF / 2) & off)
    if ea.size == 0 or np.unique(ea).size < n:
        # Isolated node(s): no neighbor group to reduce over — dense path.
        return next_hop_np(cost, dist)[:, cols]
    starts = np.searchsorted(ea, np.arange(n))
    w = cost[ea, eb]
    inf32 = np.float32(INF)
    eidx = np.arange(ea.size, dtype=np.int64)
    out = np.empty((n, cols.size), dtype=np.int32)
    bc = max(1, (32 << 20) // (8 * max(ea.size, 1)))
    for j0 in range(0, cols.size, bc):
        js = cols[j0:j0 + bc]
        sc = w[:, None] + dist[eb[:, None], js[None, :]]      # (E, C)
        gmin = np.minimum.reduceat(sc, starts, axis=0)        # (N, C)
        first = np.minimum.reduceat(
            np.where(sc == gmin[ea], eidx[:, None], ea.size), starts, axis=0)
        nhc = eb[first].astype(np.int32)
        bad = gmin >= inf32
        if bad.any():
            bi, bj = np.nonzero(bad)
            step = np.where(off, cost, inf32)
            nhc[bi, bj] = (step[bi] + dist[:, js[bj]].T).argmin(
                axis=1).astype(np.int32)
        out[:, j0:j0 + bc] = nhc
    return out


class HostTables(NamedTuple):
    """Cached host routing state for one adjacency: hop-cost matrix, APSP
    distances, next hops, plus the f64 tie-broken shadow (cost_t, dist_t)
    that powers the incremental delta — the unit of Evaluator's cache."""

    cost: np.ndarray    # (N, N) f32: 0 diag, router+wire on edges, INF absent
    dist: np.ndarray    # (N, N) f32 shortest-path distances
    nh: np.ndarray      # (N, N) int32 first-index-argmin next hops
    cost_t: np.ndarray  # (N, N) f64 cost + per-edge tie-breaker
    dist_t: np.ndarray  # (N, N) f64 perturbed distances; floor == dist

    @property
    def nbytes(self) -> int:
        return (self.cost.nbytes + self.dist.nbytes + self.nh.nbytes
                + self.cost_t.nbytes + self.dist_t.nbytes)


def host_tables(cost: np.ndarray, n_iters: int) -> HostTables:
    """Full host recompute — the delta path's fallback and seed. One f64
    APSP on the tie-broken costs yields both metrics: dist = floor(dist_t)
    (exact — see the shadow-metric note above), bit-equal to the f32
    oracle."""
    cost = np.ascontiguousarray(cost, dtype=np.float32)
    n = cost.shape[0]
    edge = (cost < INF / 2) & ~np.eye(n, dtype=bool)
    cost_t = cost.astype(np.float64)
    cost_t[edge] += _tie_eps(n).astype(np.float64)[edge]
    dist_t = apsp_np(cost_t, n_iters)
    dist = np.floor(dist_t).astype(np.float32)
    return HostTables(cost, dist, next_hop_np(cost, dist), cost_t, dist_t)


def delta_link_move(
    t: HostTables,
    rem: tuple[int, int],
    add: tuple[int, int],
    w_add: float,
    *,
    max_dirty_frac: float = 0.5,
    max_iters: int | None = None,
) -> HostTables | None:
    """Incremental tables after moving one undirected link: remove edge
    ``rem``, add edge ``add`` with hop cost ``w_add``. Bit-equal to a full
    recompute on the new cost matrix, or ``None`` when the delta bound is
    exceeded (too many touched rows/columns, or the relaxation cap is hit)
    and the caller must fall back to :func:`host_tables`.

    Three exact phases, the first two on the f64 shadow metric (unique
    perturbed shortest paths — see the tie-breaker note above):

    1. *Removal.* A pair (i, j) lengthens only if its unique perturbed
       shortest path used the removed edge: dist_t[i,j] == dist_t[i,a] +
       w_t + dist_t[b,j] (either orientation) — on tie-degenerate meshes
       this dirty set is tiny (the edge's unique-path betweenness), where
       the unperturbed test would flag most of the matrix. Dirty entries
       re-converge by sparse Jacobi–Bellman relaxation on the new shadow
       cost (an (E, N) gather per sweep, E = #dirty entries): they restart
       at INF while clean entries keep their (still exact) base value as
       the upper bound; every iterate stays >= the true distance, so the
       fixpoint is the true distance, in <= N-1 sweeps.
    2. *Addition.* A shortest path uses a new edge at most once, so
       dist'' = min(dist', dist'[:,c] + w_t + dist'[e,:], and symmetric) in
       closed form. The true f32 distances then drop out as
       floor(dist_t) — exact, bit-equal to the oracle.
    3. *Next hops.* nh[i,j] = argmin_m step[i,m] + dist[m,j] (f32 metric)
       can only change where its inputs changed: rows {a, b, c, e} (their
       step-cost row changed) and columns j whose f32 dist column changed.
       Everything else is an argmin over bit-identical arrays — unchanged
       by construction, including first-index ties."""
    n = t.cost.shape[0]
    a, b = int(rem[0]), int(rem[1])
    c, e = int(add[0]), int(add[1])
    eps = _tie_eps(n)
    cost2 = t.cost.copy()
    cost2[a, b] = cost2[b, a] = np.float32(INF)
    cost2[c, e] = cost2[e, c] = np.float32(w_add)
    w2t = np.float64(np.float32(w_add)) + np.float64(eps[c, e])
    cost2_t = t.cost_t.copy()
    cost2_t[a, b] = cost2_t[b, a] = np.float64(INF)
    cost2_t[c, e] = cost2_t[e, c] = w2t

    # Phase 1 — removal (shadow metric).
    dt = t.dist_t
    w_rem_t = t.cost_t[a, b]
    via_ab = dt[:, a:a + 1] + (w_rem_t + dt[b])[None, :]
    via_ba = dt[:, b:b + 1] + (w_rem_t + dt[a])[None, :]
    dirty = (dt == via_ab) | (dt == via_ba)
    di, dj = np.nonzero(dirty)
    dt2 = dt
    if di.size:
        # Entry bound: the dirty count is the removed edge's unique-path
        # betweenness. The byte term caps the (E, N) gather slab.
        if di.size > min(max_dirty_frac * n * n, (256 << 20) // (8 * n)):
            return None
        cap = max_iters if max_iters is not None else n
        dt2 = dt.copy()
        dt2[di, dj] = np.float64(INF)
        cost_cols = np.ascontiguousarray(cost2_t[:, dj].T)   # (E, N)
        cur = dt2[di, dj]
        for _ in range(cap):
            cand = (dt2[di, :] + cost_cols).min(axis=1)
            nd = np.minimum(cur, cand)
            if np.array_equal(nd, cur):
                break
            dt2[di, dj] = nd
            cur = nd
        else:
            return None

    # Phase 2 — addition (closed form; 1e9 + x never rounds below 1e9, so
    # unreachable-through-the-new-edge candidates can't fake a finite path).
    via_c = dt2[:, c:c + 1] + (w2t + dt2[e])[None, :]
    via_e = dt2[:, e:e + 1] + (w2t + dt2[c])[None, :]
    dt3 = np.minimum(dt2, np.minimum(via_c, via_e))
    dist3 = np.floor(dt3).astype(np.float32)

    # Phase 3 — targeted next-hop rebuild (f32 metric): full rows for the
    # four endpoints (their step-cost row changed), changed columns via the
    # sparse edge-list argmin (O(E·C); a long added link can genuinely
    # shortcut many pairs, so C is not assumed small).
    changed_cols = np.flatnonzero((dist3 != t.dist).any(axis=0))
    nh2 = t.nh.copy()
    touched_rows = np.unique(np.array([a, b, c, e], dtype=np.int32))
    nh2[touched_rows] = next_hop_np(cost2, dist3, rows=touched_rows)
    if changed_cols.size:
        nh2[:, changed_cols] = _nh_cols_sparse(cost2, dist3, changed_cols)
        nh2[changed_cols, changed_cols] = changed_cols.astype(np.int32)
    return HostTables(cost2, dist3, nh2, cost2_t, dt3)
