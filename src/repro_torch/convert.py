"""Carry trained state from the reference package (``repro``) into the port.

The reference hands its state over as plain numpy — this module imports
nothing of it:

  * a fitted reference ``RegressionForest``'s ``_flat`` dict plus its
    ``_xm``/``_xs`` normalization become a port
    :class:`~repro_torch.core.forest.RegressionForest` that predicts the
    same values (:func:`forest_from_flat`);
  * ``Design`` and ``RunResult`` need no conversion: both packages write the
    same JSON (``design_to_json`` / ``RunResult.to_json``) and read each
    other's with their own ``from_json``.
"""

from __future__ import annotations

import numpy as np

from .core.forest import RegressionForest

_FLAT_KEYS = ("feature", "threshold", "left", "right", "value", "depth")


def forest_from_flat(flat: dict, xm: np.ndarray, xs: np.ndarray, *,
                     device=None) -> RegressionForest:
    """A port forest from a reference forest's packed (T, M) arrays
    (``flat``: at least ``feature``, ``threshold``, ``left``, ``right``,
    ``value``, ``depth``) and its feature normalization ``xm``/``xs``."""
    missing = [k for k in _FLAT_KEYS if k not in flat]
    if missing:
        raise ValueError(f"flat forest lacks {missing}")
    feature = np.asarray(flat["feature"], np.int32)
    forest = RegressionForest(n_trees=feature.shape[0], device=device)
    forest.set_flat({
        "feature": feature,
        "threshold": np.asarray(flat["threshold"], np.float64),
        "left": np.asarray(flat["left"], np.int32),
        "right": np.asarray(flat["right"], np.int32),
        "value": np.asarray(flat["value"], np.float64),
        "depth": int(flat["depth"]),
        "n_nodes": feature.shape[1],
    })
    forest._xm = np.asarray(xm, np.float64)
    forest._xs = np.asarray(xs, np.float64)
    return forest
