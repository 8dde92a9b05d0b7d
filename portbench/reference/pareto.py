"""Pareto filter and hypervolume (minimisation), plain NumPy float64.

The hypervolume is "Hypervolume by Slicing Objectives" (While et al.),
which the paper cites (§5.1): slice along the first objective and sum the
slabs' (m-1)-dimensional volumes, with a closed-form 2-D staircase at the
bottom. A front's PHV is measured as the port measures it: each objective
divided by the 3D mesh's, against the reference point 1.6 in every
objective.
"""

from __future__ import annotations

import numpy as np

#: Reference point, in units of the mesh's objectives.
REF_SCALE = 1.6


def pareto_mask(points: np.ndarray) -> np.ndarray:
    """Rows not dominated by another row; of equal rows the first is kept."""
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=bool)
    le = np.all(pts[:, None, :] <= pts[None, :, :], axis=-1)
    lt = np.any(pts[:, None, :] < pts[None, :, :], axis=-1)
    mask = ~(le & lt).any(axis=0)
    seen: set[bytes] = set()
    for i in np.flatnonzero(mask):
        key = (pts[i] + 0.0).tobytes()
        if key in seen:
            mask[i] = False
        seen.add(key)
    return mask


def hypervolume(points: np.ndarray, ref: np.ndarray) -> float:
    """Volume dominated by ``points`` and bounded above by ``ref``."""
    pts = np.asarray(points, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if pts.size == 0:
        return 0.0
    pts = np.minimum(pts, ref)
    return _hso(pts[pareto_mask(pts)], ref)


def _hv2d(pts: np.ndarray, ref: np.ndarray) -> float:
    order = np.argsort(pts[:, 0], kind="stable")
    x = pts[order, 0]
    ymin = np.minimum.accumulate(pts[order, 1])
    x_hi = np.append(x[1:], ref[0])
    return float(np.sum((x_hi - x) * (ref[1] - ymin)))


def _hso(pts: np.ndarray, ref: np.ndarray) -> float:
    m = ref.shape[0]
    if pts.shape[0] == 0:
        return 0.0
    if m == 1:
        return float(max(0.0, ref[0] - pts[:, 0].min()))
    if m == 2:
        return _hv2d(pts, ref)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    vol = 0.0
    n = pts.shape[0]
    for i in range(n):
        width = (pts[i + 1, 0] if i + 1 < n else ref[0]) - pts[i, 0]
        if width <= 0.0:
            continue
        slab = pts[:i + 1, 1:]
        if m > 3:
            slab = slab[pareto_mask(slab)]
        vol += width * _hso(slab, ref[1:])
    return float(vol)


def front_phv(rows: np.ndarray, mesh_row: np.ndarray, obj_idx) -> float:
    """PHV of full objective ``rows`` over objectives ``obj_idx``, each
    divided by the mesh's (a non-positive mesh value divides by 1)."""
    rows = np.atleast_2d(np.asarray(rows, dtype=np.float64))
    if rows.shape[0] == 0 or rows.size == 0:
        return 0.0
    idx = list(obj_idx)
    base = np.asarray(mesh_row, dtype=np.float64)[idx]
    base = np.where(base <= 0, 1.0, base)
    return hypervolume(rows[:, idx] / base, np.full(len(idx), REF_SCALE))
