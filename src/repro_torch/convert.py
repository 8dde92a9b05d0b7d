"""Carry trained state from the reference package (``repro``) into the port.

The reference hands its state over as plain numpy — this module imports
nothing of it:

  * a fitted reference ``RegressionForest``'s ``_flat`` dict plus its
    ``_xm``/``_xs`` normalization become a port
    :class:`~repro_torch.core.forest.RegressionForest` that predicts the
    same values (:func:`forest_from_flat`);
  * ``Design`` and ``RunResult`` need no conversion: both packages write the
    same JSON (``design_to_json`` / ``RunResult.to_json``) and read each
    other's with their own ``from_json``;
  * a reference model's parameter pytree, as nested dicts of numpy arrays
    with stacked ``(L, ...)`` layer leaves (``encoder``/``decoder`` stacks
    for the encoder-decoder family), becomes the port's parameter
    tree for :func:`repro_torch.models.build` (:func:`params_from_jax`);
  * a reference trainer state (params, Adam moments, step and the error
    feedback, as numpy) becomes the port's train state
    (:func:`train_state_from_jax`), so both compute the same step;
  * a reference model's parameter tree becomes one rank's shards of it on
    a device mesh under a sharding policy (:func:`rank_params`), the
    splits ``dist.sharding.param_specs`` gives.
"""

from __future__ import annotations

import numpy as np

import torch

from .ckpt.checkpoint import tree_leaves
from .core.forest import RegressionForest
from .models.common import ModelConfig

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


def params_from_jax(cfg: ModelConfig, tree: dict) -> dict:
    """The port's parameter tree from a reference model's, leaf for leaf
    (the two share the layout). Leaves become CPU tensors of the same dtype;
    ``build(cfg, params, device=...)`` moves them."""
    if cfg.family == "encdec":
        expected = {"embed", "head", "enc_norm", "final_norm", "encoder",
                    "decoder"}
        stacks = {"encoder": cfg.encoder_layers, "decoder": cfg.n_layers}
    else:
        expected = {"embed", "final_norm", "layers"}
        stacks = {"layers": cfg.n_layers}
        if not cfg.tie_embeddings:
            expected.add("head")
        if cfg.family == "hybrid":
            expected.add("shared")
    if set(tree) != expected:
        raise ValueError(f"{cfg.name}: expected top-level keys "
                         f"{sorted(expected)}, got {sorted(tree)}")

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, f"{path}.{k}") for k, v in node.items()}
        arr = np.asarray(node)
        n = stacks.get(path.split(".")[0])
        if n is not None and arr.shape[0] != n:
            raise ValueError(f"{path}: expected {n} stacked layers, got "
                             f"shape {arr.shape}")
        if path.endswith(".moe.router") and arr.dtype != np.float32:
            raise ValueError(f"{path}: the MoE router is f32, got "
                             f"{arr.dtype}")
        return torch.from_numpy(np.array(arr, copy=True))

    return {k: conv(v, k) for k, v in tree.items()}


def train_state_from_jax(cfg: ModelConfig, state: dict) -> dict:
    """The port's train state ({"params", "opt": {"m", "v", "step"},
    "err"?}) from a reference trainer state of numpy leaves. CPU tensors;
    the parameters require grad."""
    params = params_from_jax(cfg, state["params"])
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = state["opt"]
    out = {"params": params,
           "opt": {"m": params_from_jax(cfg, opt["m"]),
                   "v": params_from_jax(cfg, opt["v"]),
                   "step": torch.tensor(int(np.asarray(opt["step"])),
                                        dtype=torch.int32)}}
    if "err" in state:
        out["err"] = params_from_jax(cfg, state["err"])
    return out


def rank_params(cfg: ModelConfig, tree: dict, mesh, policy=None) -> dict:
    """This rank's shards (``mesh.coords``) of a reference model's
    parameter tree on ``mesh`` under ``policy`` (``Policy()`` when None):
    contiguous CPU tensors, for ``build(cfg, ..., mesh=mesh)``'s model.
    On a one-rank mesh, the whole tree."""
    from .models.parallel import plan_for

    params = params_from_jax(cfg, tree)
    plan = plan_for(cfg, mesh, policy)
    return params if plan is None else plan.local(params)
