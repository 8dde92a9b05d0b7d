"""Pareto dominance + hypervolume (PHV) utilities.

PHV follows "Hypervolume by Slicing Objectives" (While et al. [36], cited by
the paper §5.1): recursively slice along one objective and aggregate
(m-1)-dimensional hypervolumes. All objectives are MINIMIZED; the
hypervolume is measured against an upper reference point ``ref`` and only
counts the region dominated by the set and bounded by ``ref``.

Two hot-path accelerations for the greedy PHV argmax (Alg. 1 line 3):

  * the HSO recursion bottoms out in a closed-form vectorized 2-D
    staircase (:func:`_hv2d`) instead of recursing to 1-D slabs, and
  * :func:`hypervolume_with_batch` scores PHV(S ∪ {d}) for a whole batch
    of candidates at once via exclusive contributions — one vectorized
    dominance test knocks out every candidate already covered by S, and
    survivors only pay an HSO over S clipped into the candidate's box.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..tracing import count


def dominates(a: np.ndarray, b: np.ndarray) -> bool:
    """a ≺ b (a dominates b) under minimization — paper §5.1."""
    return bool(np.all(a <= b) and np.any(a < b))


def pareto_mask(points: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated rows. Duplicate rows: first one kept."""
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=bool)
    le = np.all(pts[:, None, :] <= pts[None, :, :], axis=-1)
    lt = np.any(pts[:, None, :] < pts[None, :, :], axis=-1)
    dom = le & lt  # dom[i, j]: i dominates j
    mask = ~dom.any(axis=0)
    # Deduplicate exact ties (keep first). Keys canonicalize signed zeros:
    # -0.0 == 0.0 numerically (the rows co-dominate, neither knocks the
    # other out above), but their byte patterns differ — without `+ 0.0`
    # both would survive as "distinct" front points.
    if mask.sum() > 1:
        idx = np.flatnonzero(mask)
        seen: set[bytes] = set()
        for i in idx:
            k = (pts[i] + 0.0).tobytes()
            if k in seen:
                mask[i] = False
            else:
                seen.add(k)
    return mask


def crowding_distance(objs: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance of each row of ``objs`` (n, m): per
    objective, the boundary rows of a stable sort get INF and the others
    the gap between their neighbours over the objective's range."""
    n, m = objs.shape
    crowd = np.zeros(n)
    for j in range(m):
        order = np.argsort(objs[:, j], kind="stable")
        rng_j = objs[order[-1], j] - objs[order[0], j] + 1e-12
        crowd[order[0]] = crowd[order[-1]] = np.inf
        if n > 2:
            crowd[order[1:-1]] += (objs[order[2:], j]
                                   - objs[order[:-2], j]) / rng_j
    return crowd


def crowding_thin(objs: np.ndarray, keep: int) -> np.ndarray:
    """Indices of `keep` rows with largest crowding distance."""
    if objs.shape[0] <= keep:
        return np.arange(objs.shape[0])
    return np.argsort(-crowding_distance(objs), kind="stable")[:keep]


class ParetoArchive:
    """Incremental non-dominated archive (minimization, keep-first ties).

    :func:`pareto_mask` rebuilds an O(n²·k) dominance cube on every union;
    this archive maintains the front under *insertion*: each insert costs
    one vectorized O(front·k) pass, pruned further by a sorted view of the
    first objective (a dominator of ``p`` must satisfy ``q[0] <= p[0]``, a
    point dominated by ``p`` must satisfy ``q[0] >= p[0]``, so only the
    matching prefix/suffix of the sorted front is compared).

    Semantics match ``pareto_mask`` exactly: a candidate equal to a
    surviving member is rejected (keep-first dedup — signed zeros compare
    equal numerically, so the archive never had the ``-0.0`` byte-key bug),
    a dominated candidate is rejected, and an accepted candidate evicts the
    members it dominates. Surviving points are reported in **insertion
    order**, which is what makes :meth:`ParetoSet.merged_with
    <repro.core.local_search.ParetoSet>` built on top byte-identical to the
    historical stacked-``pareto_mask`` implementation.

    ``tag`` is an arbitrary caller id carried with each point (a row index,
    a design), returned by :meth:`insert` with the evicted members.
    """

    __slots__ = ("n_obj", "_pts", "_tags", "_k0s", "_sidx")

    def __init__(self, n_obj: int):
        self.n_obj = int(n_obj)
        self._pts = np.zeros((0, self.n_obj), dtype=np.float64)
        self._tags: list = []
        # Sorted view: _k0s is pts[:, 0] sorted ascending; _sidx[r] is the
        # row index (into _pts / _tags) at sorted position r.
        self._k0s = np.zeros((0,), dtype=np.float64)
        self._sidx = np.zeros((0,), dtype=np.int64)

    def __len__(self) -> int:
        return self._pts.shape[0]

    @property
    def points(self) -> np.ndarray:
        """(m, k) front rows, in insertion order."""
        return self._pts

    @property
    def tags(self) -> list:
        """Caller tags, aligned with :attr:`points`."""
        return self._tags

    @classmethod
    def from_front(cls, pts: np.ndarray, tags=None) -> "ParetoArchive":
        """Seed from rows that are already a mutually non-dominated,
        deduplicated front (e.g. a previous archive's output). The rows are
        trusted — no pairwise checks are run."""
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64)) + 0.0
        arch = cls(pts.shape[-1])
        if pts.size:
            arch._pts = pts.copy()
            arch._tags = (list(tags) if tags is not None
                          else list(range(pts.shape[0])))
            arch._sidx = np.argsort(pts[:, 0], kind="stable").astype(np.int64)
            arch._k0s = pts[arch._sidx, 0]
        return arch

    def insert(self, p: np.ndarray, tag=None) -> tuple[bool, list]:
        """Insert one point. Returns ``(accepted, evicted_tags)``:
        ``accepted`` is False when ``p`` is dominated by (or equal to) a
        member; ``evicted_tags`` lists the members ``p`` knocked out."""
        p = np.asarray(p, dtype=np.float64).reshape(self.n_obj) + 0.0
        m = self._pts.shape[0]
        evicted: list = []
        if m:
            # Prefix (k0 <= p0): the only rows that can dominate/equal p.
            hi = int(np.searchsorted(self._k0s, p[0], side="right"))
            if hi:
                pre = self._sidx[:hi]
                if bool(np.all(self._pts[pre] <= p, axis=1).any()):
                    return False, []
            # Suffix (k0 >= p0): the only rows p can dominate.
            lo = int(np.searchsorted(self._k0s, p[0], side="left"))
            suf = self._sidx[lo:]
            if suf.size:
                out = suf[np.all(p <= self._pts[suf], axis=1)]
                if out.size:
                    evicted = self._remove_rows(np.sort(out))
        row = self._pts.shape[0]
        self._pts = np.vstack([self._pts, p[None]])
        self._tags.append(tag)
        pos = int(np.searchsorted(self._k0s, p[0], side="right"))
        self._k0s = np.insert(self._k0s, pos, p[0])
        self._sidx = np.insert(self._sidx, pos, row)
        return True, evicted

    def _remove_rows(self, rows: np.ndarray) -> list:
        """Drop front rows (sorted ascending row indices) and remap the
        sorted view. O(front). Returns the evicted tags."""
        evicted = [self._tags[r] for r in rows]
        keep = np.ones(self._pts.shape[0], dtype=bool)
        keep[rows] = False
        remap = np.cumsum(keep) - 1       # old row -> new row (kept rows)
        self._pts = self._pts[keep]
        self._tags = [t for t, k in zip(self._tags, keep) if k]
        skeep = keep[self._sidx]
        self._sidx = remap[self._sidx[skeep]]
        self._k0s = self._k0s[skeep]
        return evicted

    def insert_many(self, pts: np.ndarray, tags=None) -> list:
        """Insert rows in order; returns the accepted tags (in insertion
        order — note later rows may still evict earlier ones)."""
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        accepted = []
        for i, p in enumerate(pts):
            tag = tags[i] if tags is not None else i
            ok, _ = self.insert(p, tag)
            if ok:
                accepted.append(tag)
        return accepted


def pareto_filter(points: np.ndarray) -> np.ndarray:
    return np.asarray(points)[pareto_mask(points)]


def hypervolume(points: np.ndarray, ref: np.ndarray) -> float:
    """Hypervolume (minimization) of ``points`` w.r.t. upper bound ``ref``.

    Points at or beyond ``ref`` in any coordinate contribute only their
    clipped part. Implemented as recursive HSO with memo on the first axis.
    """
    pts = np.asarray(points, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if pts.size == 0:
        return 0.0
    pts = np.minimum(pts, ref)  # clip (degenerate slices contribute 0 width)
    pts = pareto_filter(pts)
    return _hso(pts, ref)


def _hv2d(pts: np.ndarray, ref: np.ndarray) -> float:
    """Exact 2-D hypervolume: one sort + a vectorized staircase sweep.

    Handles dominated/duplicate points (zero-width or covered steps); the
    inputs must already be clipped to ``ref``."""
    order = np.argsort(pts[:, 0], kind="stable")
    x = pts[order, 0]
    ymin = np.minimum.accumulate(pts[order, 1])
    x_hi = np.empty_like(x)
    x_hi[:-1] = x[1:]
    x_hi[-1] = ref[0]
    return float(np.sum((x_hi - x) * (ref[1] - ymin)))


def _hso(pts: np.ndarray, ref: np.ndarray) -> float:
    m = ref.shape[0]
    if pts.shape[0] == 0:
        return 0.0
    if m == 1:
        return float(max(0.0, ref[0] - pts[:, 0].min()))
    if m == 2:
        return _hv2d(pts, ref)
    order = np.argsort(pts[:, 0], kind="stable")
    pts = pts[order]
    vol = 0.0
    n = pts.shape[0]
    for i in range(n):
        x_lo = pts[i, 0]
        x_hi = pts[i + 1, 0] if i + 1 < n else ref[0]
        width = x_hi - x_lo
        if width <= 0.0:
            continue
        slab = pts[: i + 1, 1:]
        if m > 3:  # 2-D slabs go straight to the staircase
            slab = pareto_filter(slab)
        vol += width * _hso(slab, ref[1:])
    return float(vol)


def hypervolume_with_batch(points: np.ndarray, cands: np.ndarray,
                           ref: np.ndarray) -> np.ndarray:
    """HV(points ∪ {c}) for every row ``c`` of ``cands`` — the batched form
    of the greedy argmax_d PHV(S ∪ {d}) scoring step (Alg. 1 line 3).

    Exact: HV(S ∪ {c}) = HV(S) + exclusive contribution of ``c``, where the
    exclusive contribution is Vol(box(c, ref)) minus the hypervolume of S
    clipped into that box. Candidates covered by S (some s <= c) are
    eliminated by one vectorized dominance test and cost nothing."""
    pts = np.asarray(points, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    cands = np.atleast_2d(np.asarray(cands, dtype=np.float64))
    c = np.minimum(cands, ref)
    box = np.prod(np.maximum(ref - c, 0.0), axis=1)
    count("noc.phv.candidates", c.shape[0])
    if pts.size == 0:
        return box.copy()
    pts = pareto_filter(np.minimum(pts, ref))
    base = _hso(pts, ref)
    out = np.full(c.shape[0], base)
    covered = np.any(np.all(pts[None, :, :] <= c[:, None, :], axis=2), axis=1)
    survivors = np.flatnonzero(~covered & (box > 0))
    count("noc.phv.hso", survivors.size)
    for i in survivors:
        clipped = np.maximum(pts, c[i])
        vol_sub = _hso(clipped[pareto_mask(clipped)], ref)
        out[i] = base + (box[i] - vol_sub)
    return out


PHV_BACKENDS = ("host", "device")


class PhvContext:
    """Fixed normalization for PHV across one optimization run.

    Objectives are divided by the starting (3D-mesh) design's objective
    values, so every search for a given (spec, traffic, case) shares one
    scale; the reference point is ``ref_scale`` in those units (designs worse
    than ``ref_scale``x mesh contribute zero volume).

    ``phv_backend`` selects the batched scorer behind
    :meth:`phv_with_batch` (the chain-step hot path): ``"host"`` (default)
    is the exact f64 HSO here; ``"device"`` routes through the f32 twin
    (core.phv_torch) on ``device`` (default ``"cuda"``) — one program of
    tensor operations per chain step instead of a per-survivor host
    recursion. The twin is opt-in because f32 cannot resolve the chain
    accept test's 1e-12 epsilon near convergence (its conformance bound is
    ~1e-5 relative); scalar entry points (``phv``, ``phv_with``) always stay
    host-exact."""

    def __init__(self, mesh_objs: np.ndarray, obj_idx: tuple[int, ...],
                 ref_scale: float = 1.6, phv_backend: str = "host",
                 device=None):
        if phv_backend == "jnp":
            raise ValueError(
                "phv_backend 'jnp' is replaced in repro_torch by 'device' "
                "(the f32 twin in core.phv_torch)")
        if phv_backend not in PHV_BACKENDS:
            raise ValueError(
                f"phv_backend must be one of {PHV_BACKENDS}, "
                f"got {phv_backend!r}")
        self.obj_idx = tuple(obj_idx)
        self.phv_backend = phv_backend
        self.device = (resolve_device(device) if phv_backend == "device"
                       else None)
        base = np.asarray(mesh_objs, dtype=np.float64)[list(obj_idx)]
        base = np.where(base <= 0, 1.0, base)
        self.base = base
        self.ref = np.full(len(obj_idx), ref_scale, dtype=np.float64)

    def normalize(self, objs: np.ndarray) -> np.ndarray:
        o = np.asarray(objs, dtype=np.float64)
        sel = o[..., list(self.obj_idx)]
        return sel / self.base

    def phv(self, objs: np.ndarray) -> float:
        """PHV of a set of (full 5-dim) objective rows under this context."""
        if objs.size == 0:
            return 0.0
        return hypervolume(self.normalize(np.atleast_2d(objs)), self.ref)

    def phv_with(self, set_objs: np.ndarray, extra: np.ndarray) -> float:
        """PHV(S ∪ {d}) — Alg. 1 line 3."""
        ext = np.atleast_2d(extra)
        if set_objs.size == 0:
            return self.phv(ext)
        return self.phv(np.vstack([np.atleast_2d(set_objs), ext]))

    def phv_with_batch(self, set_objs: np.ndarray,
                       extras: np.ndarray) -> np.ndarray:
        """(B,) array of PHV(S ∪ {d_b}) for a batch of candidate rows —
        one call scores a whole neighborhood (Alg. 1 line 3) instead of B
        recursive-HSO invocations."""
        ext = self.normalize(np.atleast_2d(extras))
        if set_objs.size == 0:
            setn = np.zeros((0, len(self.obj_idx)))
        else:
            setn = self.normalize(np.atleast_2d(set_objs))
        if self.phv_backend == "device" and len(self.obj_idx) <= 4:
            # m = 5 would batch an O(S^3) masked recursion — past the twin's
            # win; no active case uses it, so it stays host-served.
            from .phv_torch import hypervolume_with_batch_torch

            return hypervolume_with_batch_torch(setn, ext, self.ref,
                                                device=self.device)
        return hypervolume_with_batch(setn, ext, self.ref)
