"""Regression forest (bagged CART) — the paper's base learner for Eval.

The fit is the reference's numpy implementation (``repro.core.forest``),
unchanged, so the same seed grows the same trees. After fitting, the forest
is flattened into struct-of-arrays form: per-tree ``feature`` /
``threshold`` / ``left`` / ``right`` / ``value`` arrays packed into one
padded (T, M) tensor with self-looping leaves. ``predict`` has two
backends:

  * ``"auto"``  — the device path: kernel K2 (``csrc/forest.cu``, on the
    node records of :meth:`RegressionForest.packed`) for a CUDA device, its
    plain PyTorch version on the CPU; f32 compares, tree mean in a fixed
    order;
  * ``"numpy"`` — the f64 host oracle (flat vectorized traversal).

The reference's ``"jnp"`` and ``"pallas"`` backends are replaced by
``"auto"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops

FOREST_BACKENDS = ("auto", "numpy")


def check_forest_backend(backend: str | None, *,
                         allow_none: bool = False) -> None:
    """Membership check for every forest_backend knob. ``allow_none``
    admits the configs' "inherit the problem's knob" sentinel."""
    if backend is None and allow_none:
        return
    if backend in ("jnp", "pallas"):
        raise ValueError(
            f"forest_backend {backend!r} is replaced in repro_torch by "
            "'auto' (the device path: CUDA kernel on a card, plain version "
            "on the CPU)")
    if backend not in FOREST_BACKENDS:
        raise ValueError(
            f"forest_backend must be one of {FOREST_BACKENDS}, "
            f"got {backend!r}")


class _Tree:
    __slots__ = ("feature", "threshold", "left", "right", "value")

    def __init__(self):
        self.feature = -1
        self.threshold = 0.0
        self.left = None
        self.right = None
        self.value = 0.0


def _build(x, y, rng, depth, max_depth, min_leaf, n_feat_try):
    node = _Tree()
    node.value = float(y.mean())
    if depth >= max_depth or y.shape[0] < 2 * min_leaf or np.ptp(y) < 1e-12:
        return node
    n, f = x.shape
    best = (None, None, np.inf)
    for feat in rng.choice(f, size=min(n_feat_try, f), replace=False):
        xs = x[:, feat]
        order = np.argsort(xs, kind="stable")
        xs_s, y_s = xs[order], y[order]
        # candidate split points between distinct neighbor values
        csum = np.cumsum(y_s)
        csq = np.cumsum(y_s**2)
        tot, tot2 = csum[-1], csq[-1]
        idx = np.arange(min_leaf, n - min_leaf)
        if idx.size == 0:
            continue
        valid = xs_s[idx] < xs_s[idx + 1] - 1e-15
        idx = idx[valid]
        if idx.size == 0:
            continue
        nl = idx + 1.0
        nr = n - nl
        sse = (csq[idx] - csum[idx] ** 2 / nl) + (
            (tot2 - csq[idx]) - (tot - csum[idx]) ** 2 / nr
        )
        j = int(np.argmin(sse))
        if sse[j] < best[2]:
            thr = 0.5 * (xs_s[idx[j]] + xs_s[idx[j] + 1])
            best = (int(feat), float(thr), float(sse[j]))
    if best[0] is None:
        return node
    node.feature, node.threshold = best[0], best[1]
    mask = x[:, node.feature] <= node.threshold
    node.left = _build(x[mask], y[mask], rng, depth + 1, max_depth, min_leaf, n_feat_try)
    node.right = _build(x[~mask], y[~mask], rng, depth + 1, max_depth, min_leaf, n_feat_try)
    return node


def _flatten_tree(root: _Tree):
    """Preorder struct-of-arrays form of one tree.

    Leaves get ``feature = -1`` and self-loop children, so traversal past a
    leaf is the identity and every sample can be advanced the same (max)
    number of steps."""
    feature: list[int] = []
    threshold: list[float] = []
    left: list[int] = []
    right: list[int] = []
    value: list[float] = []
    depth = 0

    def rec(node: _Tree, d: int) -> int:
        nonlocal depth
        depth = max(depth, d)
        i = len(feature)
        feature.append(-1 if node.left is None else node.feature)
        threshold.append(node.threshold)
        value.append(node.value)
        left.append(i)
        right.append(i)
        if node.left is not None:
            left[i] = rec(node.left, d + 1)
            right[i] = rec(node.right, d + 1)
        return i

    rec(root, 0)
    return (np.asarray(feature, np.int32), np.asarray(threshold, np.float64),
            np.asarray(left, np.int32), np.asarray(right, np.int32),
            np.asarray(value, np.float64), depth)


class RegressionForest:
    """Bagged CART regressor. ``device`` is where the ``"auto"`` backend
    predicts (default ``"cuda"``, resolved at the first device predict)."""

    def __init__(self, n_trees: int = 24, max_depth: int = 9,
                 min_leaf: int = 3, seed: int = 0, backend: str = "auto",
                 device: str | torch.device | None = None):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        check_forest_backend(backend)
        self.backend = backend
        self.device = device
        self.rng = np.random.default_rng(seed)
        self.trees: list[_Tree] = []
        self._xm = self._xs = None
        self._flat = None          # packed (T, M) numpy tensors
        self._dev_nodes = None     # (device, (T, M) tensors)
        self._packed = None        # (device, ops.PackedForest)

    def fit(self, x: np.ndarray, y: np.ndarray) -> "RegressionForest":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        self._xm = x.mean(0)
        self._xs = x.std(0) + 1e-9
        xn = (x - self._xm) / self._xs
        n = x.shape[0]
        n_feat_try = max(1, int(np.ceil(np.sqrt(x.shape[1]))) + 1)
        self.trees = []
        for _ in range(self.n_trees):
            idx = self.rng.integers(0, n, size=n)
            self.trees.append(
                _build(xn[idx], y[idx], self.rng, 0, self.max_depth,
                       self.min_leaf, n_feat_try)
            )
        self._pack()
        return self

    # ------------------------------------------------------------ flattening
    def _pack(self):
        flats = [_flatten_tree(t) for t in self.trees]
        t = len(flats)
        m = max(f[0].shape[0] for f in flats)
        feature = np.full((t, m), -1, np.int32)
        threshold = np.zeros((t, m), np.float64)
        left = np.tile(np.arange(m, dtype=np.int32), (t, 1))
        right = left.copy()
        value = np.zeros((t, m), np.float64)
        depth = 0
        for i, (fe, th, le, ri, va, de) in enumerate(flats):
            k = fe.shape[0]
            feature[i, :k] = fe
            threshold[i, :k] = th
            left[i, :k] = le
            right[i, :k] = ri
            value[i, :k] = va
            depth = max(depth, de)
        self.set_flat({"feature": feature, "threshold": threshold,
                       "left": left, "right": right, "value": value,
                       "depth": depth, "n_nodes": m})

    def set_flat(self, flat: dict) -> None:
        """Install the packed (T, M) arrays (``feature``, ``threshold``,
        ``left``, ``right``, ``value``, ``depth``, ``n_nodes``) and derive
        the flat-absolute layout the numpy oracle traverses."""
        t, m = flat["feature"].shape
        # Flat-absolute children (child[2i] = left, child[2i+1] = right);
        # leaves self-loop, and leaf features are clamped to 0 so the
        # x-gather stays in bounds.
        offs = (np.arange(t, dtype=np.int64) * m)[:, None]
        child = np.empty((t, m, 2), np.int64)
        child[:, :, 0] = flat["left"] + offs
        child[:, :, 1] = flat["right"] + offs
        self._flat = {
            "feature": flat["feature"], "threshold": flat["threshold"],
            "left": flat["left"], "right": flat["right"],
            "value": flat["value"],
            "child_flat": child.reshape(-1),
            "feat_safe_flat": np.maximum(flat["feature"], 0).astype(
                np.int64).reshape(-1),
            "threshold_flat": flat["threshold"].reshape(-1),
            "value_flat": flat["value"].reshape(-1),
            "depth": int(flat["depth"]), "n_nodes": int(m),
        }
        self._dev_nodes = None
        self._packed = None

    @property
    def n_fitted_trees(self) -> int:
        return self._flat["feature"].shape[0]

    # -------------------------------------------------------------- predict
    def _normalize(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x, np.float64))
        return (x - self._xm) / self._xs

    def predict(self, x: np.ndarray, backend: str | None = None) -> np.ndarray:
        """(B,) forest mean: the device path (``"auto"``) or the f64 numpy
        oracle (``"numpy"``)."""
        b = backend if backend is not None else self.backend
        check_forest_backend(b)
        xn = self._normalize(x)
        if b == "numpy":
            return self._predict_numpy(xn)
        packed = self.packed()
        xt = torch.as_tensor(xn.astype(np.float32),
                             device=packed.value.device)
        out = ops.forest_predict_packed(packed, xt)
        return out.cpu().numpy().astype(np.float64)

    def device_nodes(self, device: str | torch.device | None = None
                     ) -> tuple[torch.Tensor, ...]:
        """(threshold f32, feature i32 clamped, child (T, 2M) i32
        interleaved, value f32) on ``device`` (default: the forest's) — the
        plain versions' layout; built once per forest and device."""
        dev = resolve_device(device if device is not None else self.device)
        if self._dev_nodes is None or self._dev_nodes[0] != dev:
            fl = self._flat
            t, m = fl["feature"].shape
            child = np.empty((t, 2 * m), np.int32)
            child[:, 0::2] = fl["left"]
            child[:, 1::2] = fl["right"]
            arrs = (fl["threshold"].astype(np.float32),
                    np.maximum(fl["feature"], 0).astype(np.int32), child,
                    fl["value"].astype(np.float32))
            self._dev_nodes = (dev, tuple(torch.as_tensor(a, device=dev)
                                          for a in arrs))
        return self._dev_nodes[1]

    def packed(self, device: str | torch.device | None = None
               ) -> ops.PackedForest:
        """:meth:`device_nodes` packed into the node records of kernels K2
        and K3 (``ops.pack_forest``); built and checked once per forest and
        device."""
        dev = resolve_device(device if device is not None else self.device)
        if self._packed is None or self._packed[0] != dev:
            self._packed = (dev, ops.pack_forest(*self.device_nodes(dev),
                                                 self._flat["depth"]))
        return self._packed[1]

    def _predict_numpy(self, xn: np.ndarray) -> np.ndarray:
        """Flat vectorized traversal: node pointers advanced ``depth`` times
        with 1-D ``np.take`` gathers, f64 compares, ``np.mean`` over the
        tree axis.

        Small batches (the meta-search neighborhood path) use one (T, B)
        pointer block — 4 gathers per level total; big batches iterate per
        tree so the gather working set stays cache-resident."""
        fl = self._flat
        t, m, depth = self.n_fitted_trees, fl["n_nodes"], fl["depth"]
        b = xn.shape[0]
        feat = fl["feat_safe_flat"]
        thr = fl["threshold_flat"]
        child = fl["child_flat"]
        xnf = np.ascontiguousarray(xn).ravel()
        cols = np.arange(b, dtype=np.int64) * xn.shape[1]
        if b <= 1024:
            idx = (np.arange(t, dtype=np.int64) * m)[:, None] + np.zeros(
                (1, b), np.int64)
            for _ in range(depth):
                fi = np.take(feat, idx)
                xv = np.take(xnf, fi + cols[None, :])
                go_right = np.take(thr, idx) < xv
                idx = np.take(child, (idx << 1) + go_right)
            return np.take(fl["value_flat"], idx).mean(axis=0)
        vals = np.empty((t, b))
        for ti in range(t):
            idx = np.full(b, ti * m, np.int64)
            for _ in range(depth):
                fi = np.take(feat, idx)
                xv = np.take(xnf, fi + cols)
                go_right = np.take(thr, idx) < xv
                idx = np.take(child, (idx << 1) + go_right)
            vals[ti] = np.take(fl["value_flat"], idx)
        return np.mean(vals, axis=0)
