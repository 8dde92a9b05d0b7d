"""Cheap structural design features for the STAGE evaluation function.

STAGE's Eval must be much cheaper than a local search (paper §5.2), so the
features are O(N^2) numpy reads of the design itself — no routing, no
objective evaluation:

  geometry of the placement (where each core class sits, depth from sink),
  link structure (per-layer counts, lengths, degrees), and
  proximity structure between communicating classes (CPU/GPU vs LLC).

These are exactly the quantities the paper's qualitative analysis (§6.3,
Fig. 7/12: "LLCs in middle layers", "links concentrate near LLCs") says
predict design quality.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .problem import CPU, GPU, LLC, Design, SystemSpec

FEATURE_NAMES = (
    "llc_mean_layer", "llc_std_layer", "cpu_mean_layer", "gpu_mean_layer",
    "power_depth", "col_power_std",
    "links_layer_entropy", "link_len_mean", "link_len_std",
    "deg_mean", "deg_std", "deg_max",
    "llc_deg_mean", "cpu_llc_dist", "gpu_llc_dist", "llc_link_frac",
)


def design_features(spec: SystemSpec, d: Design) -> np.ndarray:
    """(F,) float feature vector — see FEATURE_NAMES."""
    coords = spec.coords
    layer = coords[:, 0].astype(np.float64)
    types = spec.core_types[d.perm]
    power = spec.core_power[d.perm]
    k = spec.n_layers

    is_cpu, is_llc, is_gpu = types == CPU, types == LLC, types == GPU

    # Placement geometry.
    llc_mean_layer = layer[is_llc].mean() / k
    llc_std_layer = layer[is_llc].std() / k
    cpu_mean_layer = layer[is_cpu].mean() / k
    gpu_mean_layer = layer[is_gpu].mean() / k
    power_depth = float((power * layer).sum() / (power.sum() * k))
    col = coords[:, 1] * spec.ny + coords[:, 2]
    col_power = np.bincount(col, weights=power, minlength=spec.tiles_per_layer)
    col_power_std = float(col_power.std() / (col_power.mean() + 1e-9))

    # Link structure.
    iu = np.triu_indices(spec.n_tiles, 1)
    link_mask = d.adj[iu]
    link_layers = layer[iu[0]][link_mask]
    counts = np.bincount(link_layers.astype(int), minlength=k).astype(np.float64)
    p = counts / counts.sum()
    links_layer_entropy = float(-(p * np.log(p + 1e-12)).sum() / np.log(k))
    lens = spec.manhattan[iu][link_mask]
    link_len_mean = float(lens.mean())
    link_len_std = float(lens.std())
    full = d.adj | spec.vertical_adj
    deg = full.sum(1).astype(np.float64)
    llc_deg_mean = float(deg[is_llc].mean())

    # Class-proximity (geometric stand-in for routed hop distance).
    man = spec.manhattan + 1.0 * np.abs(layer[:, None] - layer[None, :])
    def class_dist(a, b):
        return float(man[np.ix_(a, b)].mean())
    cpu_llc = class_dist(np.flatnonzero(is_cpu), np.flatnonzero(is_llc))
    gpu_llc = class_dist(np.flatnonzero(is_gpu), np.flatnonzero(is_llc))

    # Fraction of planar links with an LLC endpoint (paper Fig. 7 insight).
    llc_slots = is_llc
    ends_llc = llc_slots[iu[0]] | llc_slots[iu[1]]
    llc_link_frac = float((ends_llc & link_mask).sum() / max(link_mask.sum(), 1))

    return np.array([
        llc_mean_layer, llc_std_layer, cpu_mean_layer, gpu_mean_layer,
        power_depth, col_power_std,
        links_layer_entropy, link_len_mean, link_len_std,
        float(deg.mean()), float(deg.std()), float(deg.max()),
        llc_deg_mean, cpu_llc, gpu_llc, llc_link_frac,
    ])


@lru_cache(maxsize=16)
def _batch_consts(spec: SystemSpec) -> dict:
    """Spec-static quantities for the batched extractor (one per spec)."""
    layer = spec.coords[:, 0].astype(np.float64)
    k = spec.n_layers
    iu0, iu1 = np.triu_indices(spec.n_tiles, 1)
    col = spec.coords[:, 1] * spec.ny + spec.coords[:, 2]
    col_onehot = np.zeros((spec.n_tiles, spec.tiles_per_layer))
    col_onehot[np.arange(spec.n_tiles), col] = 1.0
    link_layer = layer[iu0].astype(int)
    layer_onehot = np.zeros((iu0.shape[0], k))
    layer_onehot[np.arange(iu0.shape[0]), link_layer] = 1.0
    man2 = spec.manhattan + 1.0 * np.abs(layer[:, None] - layer[None, :])
    return {
        "layer": layer, "k": k, "iu0": iu0, "iu1": iu1,
        "col_onehot": col_onehot, "layer_onehot": layer_onehot,
        "lens": spec.manhattan[iu0, iu1], "man2": man2,
        "vert_deg": spec.vertical_adj.sum(1).astype(np.float64),
        "is_cpu": spec.core_types == CPU,
        "is_llc": spec.core_types == LLC,
        "is_gpu": spec.core_types == GPU,
    }


def _masked_mean_std(x: np.ndarray, mask: np.ndarray):
    """Mean/std of ``x`` (broadcast row) over each row of boolean ``mask``."""
    cnt = mask.sum(1)
    m1 = (x * mask).sum(1) / cnt
    m2 = (x * x * mask).sum(1) / cnt
    return m1, np.sqrt(np.maximum(m2 - m1 * m1, 0.0))


def design_features_batch(spec: SystemSpec, designs: list[Design]) -> np.ndarray:
    """(B, F) feature matrix — the vectorized form of
    :func:`design_features`, one numpy pass over the whole batch (the
    MOO-STAGE meta-search scores entire neighborhoods per step).

    Agrees with the scalar extractor to float round-off (sums are taken in a
    different order); pinned by tests."""
    c = _batch_consts(spec)
    b = len(designs)
    if b == 0:
        return np.zeros((0, len(FEATURE_NAMES)))
    perms = np.stack([d.perm for d in designs])          # (B, N)
    adjs = np.stack([d.adj for d in designs])            # (B, N, N)
    layer, k = c["layer"], c["k"]
    is_cpu = c["is_cpu"][perms]
    is_llc = c["is_llc"][perms]
    is_gpu = c["is_gpu"][perms]
    power = spec.core_power[perms]

    # Placement geometry.
    llc_mean_layer, llc_std_layer = _masked_mean_std(layer[None, :], is_llc)
    cpu_mean_layer = (layer * is_cpu).sum(1) / is_cpu.sum(1)
    gpu_mean_layer = (layer * is_gpu).sum(1) / is_gpu.sum(1)
    power_depth = (power * layer).sum(1) / (power.sum(1) * k)
    col_power = power @ c["col_onehot"]                  # (B, P)
    col_power_std = col_power.std(1) / (col_power.mean(1) + 1e-9)

    # Link structure.
    link_mask = adjs[:, c["iu0"], c["iu1"]]              # (B, E)
    counts = link_mask.astype(np.float64) @ c["layer_onehot"]
    p = counts / counts.sum(1, keepdims=True)
    links_layer_entropy = -(p * np.log(p + 1e-12)).sum(1) / np.log(k)
    link_len_mean, link_len_std = _masked_mean_std(c["lens"][None, :], link_mask)
    deg = adjs.sum(2) + c["vert_deg"][None, :]           # (B, N)
    llc_deg_mean = (deg * is_llc).sum(1) / is_llc.sum(1)

    # Class-proximity (geometric stand-in for routed hop distance).
    man2 = c["man2"]
    n_cpu_llc = is_cpu.sum(1) * is_llc.sum(1)
    cpu_llc = np.einsum("bi,ij,bj->b", is_cpu + 0.0, man2, is_llc + 0.0) / n_cpu_llc
    gpu_llc = np.einsum("bi,ij,bj->b", is_gpu + 0.0, man2, is_llc + 0.0) / (
        is_gpu.sum(1) * is_llc.sum(1))

    # Fraction of planar links with an LLC endpoint (paper Fig. 7 insight).
    ends_llc = is_llc[:, c["iu0"]] | is_llc[:, c["iu1"]]
    llc_link_frac = (ends_llc & link_mask).sum(1) / np.maximum(link_mask.sum(1), 1)

    return np.stack([
        llc_mean_layer / k, llc_std_layer / k, cpu_mean_layer / k,
        gpu_mean_layer / k, power_depth, col_power_std,
        links_layer_entropy, link_len_mean, link_len_std,
        deg.mean(1), deg.std(1), deg.max(1),
        llc_deg_mean, cpu_llc, gpu_llc, llc_link_frac,
    ], axis=1)
