"""Synthetic heterogeneous traffic, calibrated to the paper's §3 study.

gem5-gpu full-system traces are not available offline, so we *simulate the
data gate*: a parametric generator that reproduces every statistic the paper
reports about its measured traffic (Figs. 1–2):

  * one CPU "master core" contributes the majority of CPU traffic;
  * GPU<->LLC traffic is near-uniform (well-parallelized kernels) and large;
  * >80% of total traffic touches an LLC (many-to-few);
  * CPU<->GPU and GPU<->GPU traffic is negligible;
  * application-specific variation exists but is second-order.

Each of the paper's ten applications (Table 1) gets a seed + mild parameter
jitter (LLC popularity skew, CPU/GPU intensity ratio, master-core share), so
cross-application similarity/variation mirrors the paper's observation that
traffic is architecture- rather than application-dominated.

Units are relative flits/cycle; each matrix is normalized to sum to 1 and
scaled by a per-application injection intensity.
"""

from __future__ import annotations

import numpy as np

from .problem import CPU, GPU, LLC, SystemSpec


class TrafficValidationError(ValueError):
    """A traffic specification failed validation — unknown application or
    model/phase name, a mesh that does not tile the GPU pool, or an explicit
    matrix that is non-square / non-finite / negative / all-zero. Raised at
    problem-construction time so bad requests are rejected at admission
    instead of crashing a worker mid-run."""

# Paper Table 1 applications. The intensity scalar is a relative injection
# rate (flits/cycle) used by netsim and EDP; values span the moderate range
# typical of Rodinia-class workloads.
APPLICATIONS: dict[str, dict] = {
    "BP":  dict(seed=101, intensity=0.48, llc_skew=0.25, master_share=0.72, cpu_frac=0.055),
    "BFS": dict(seed=102, intensity=0.62, llc_skew=0.35, master_share=0.78, cpu_frac=0.070),
    "CDN": dict(seed=103, intensity=0.70, llc_skew=0.20, master_share=0.70, cpu_frac=0.045),
    "GAU": dict(seed=104, intensity=0.44, llc_skew=0.30, master_share=0.75, cpu_frac=0.060),
    "HS":  dict(seed=105, intensity=0.55, llc_skew=0.22, master_share=0.74, cpu_frac=0.050),
    "LEN": dict(seed=106, intensity=0.66, llc_skew=0.18, master_share=0.71, cpu_frac=0.040),
    "LUD": dict(seed=107, intensity=0.50, llc_skew=0.28, master_share=0.76, cpu_frac=0.065),
    "NW":  dict(seed=108, intensity=0.40, llc_skew=0.32, master_share=0.80, cpu_frac=0.075),
    "KNN": dict(seed=109, intensity=0.58, llc_skew=0.24, master_share=0.73, cpu_frac=0.055),
    "PF":  dict(seed=110, intensity=0.52, llc_skew=0.26, master_share=0.77, cpu_frac=0.060),
}

APP_NAMES = tuple(APPLICATIONS)


def traffic_matrix(spec: SystemSpec, app: str) -> np.ndarray:
    """(N_cores, N_cores) relative flit rates f_ij for ``app`` on ``spec``.

    f[i, j] is directed traffic from core i to core j (requests one way,
    responses the other; both are generated)."""
    p = APPLICATIONS[app]
    rng = np.random.default_rng(p["seed"] + 7919 * spec.n_tiles)
    n = spec.n_tiles
    C, M, G = spec.n_cpu, spec.n_llc, spec.n_gpu
    cpus = np.arange(0, C)
    llcs = np.arange(C, C + M)
    gpus = np.arange(C + M, n)

    f = np.zeros((n, n), dtype=np.float64)

    # LLC popularity: mildly skewed (address interleaving is not perfect).
    pop = rng.dirichlet(np.full(M, 1.0 / max(p["llc_skew"], 1e-3)))
    pop = 0.5 * pop + 0.5 / M  # keep near-uniform, per Fig. 1

    # --- GPU <-> LLC: near-uniform many-to-few, dominates total traffic.
    gpu_w = 1.0 + 0.15 * rng.standard_normal(G).clip(-2, 2)  # per-GPU jitter
    gpu_w = np.maximum(gpu_w, 0.2)
    for gi, g in enumerate(gpus):
        for mi, m in enumerate(llcs):
            req = gpu_w[gi] * pop[mi]
            f[g, m] += req           # read requests / writebacks
            f[m, g] += 2.0 * req     # response data (cache lines are wider)

    # --- CPU <-> LLC: small share, master core dominates (paper §3).
    cpu_w = np.full(C, (1.0 - p["master_share"]) / max(C - 1, 1))
    cpu_w[0] = p["master_share"]
    for ci, c in enumerate(cpus):
        for mi, m in enumerate(llcs):
            req = cpu_w[ci] * pop[mi]
            f[c, m] += req
            f[m, c] += 2.0 * req

    # --- negligible CORE-CORE traffic (coherence, atomics, launch control).
    for c in cpus:
        for g in gpus:
            t = rng.uniform(0.1, 0.5)
            f[c, g] += t
            f[g, c] += t
    for _ in range(G):
        a, b = rng.choice(gpus, size=2, replace=False)
        f[a, b] += rng.uniform(0.05, 0.2)

    # Normalize blocks to hit target shares: LLC-involved >= ~80% (Fig. 2).
    llc_mask = np.zeros((n, n), dtype=bool)
    llc_mask[llcs, :] = True
    llc_mask[:, llcs] = True
    core_core = f * ~llc_mask
    llc_traffic = f * llc_mask
    cpu_rows = np.zeros((n, n), dtype=bool)
    cpu_rows[cpus, :] = True
    cpu_rows[:, cpus] = True
    cpu_llc = llc_traffic * cpu_rows
    gpu_llc = llc_traffic * ~cpu_rows

    core_share = 1.0 - rng.uniform(0.82, 0.93)      # CORE-CORE share (Fig. 2)
    cpu_frac = p["cpu_frac"]                         # CPU-LLC share of total

    def _norm(x, target):
        s = x.sum()
        return x * (target / s) if s > 0 else x

    f = (
        _norm(gpu_llc, 1.0 - core_share - cpu_frac)
        + _norm(cpu_llc, cpu_frac)
        + _norm(core_core, core_share)
    )
    return f * p["intensity"]


def avg_traffic(spec: SystemSpec, apps: list[str]) -> np.ndarray:
    """Aggregated traffic profile (paper §6.4 'AVG'): per-app matrices are
    normalized to unit sum, then averaged — so no single heavy app dominates."""
    mats = []
    for a in apps:
        m = traffic_matrix(spec, a)
        mats.append(m / m.sum())
    out = np.mean(mats, axis=0)
    mean_intensity = float(np.mean([APPLICATIONS[a]["intensity"] for a in apps]))
    return out * mean_intensity


def traffic_stats(spec: SystemSpec, f: np.ndarray) -> dict:
    """The §3 statistics (used by tests + EXPERIMENTS.md validation)."""
    C, M = spec.n_cpu, spec.n_llc
    n = spec.n_tiles
    llcs = slice(C, C + M)
    llc_mask = np.zeros((n, n), dtype=bool)
    llc_mask[llcs, :] = True
    llc_mask[:, llcs] = True
    total = f.sum()
    cpu_out = f[:C, llcs].sum(axis=1)
    return dict(
        llc_share=float((f * llc_mask).sum() / total),
        core_core_share=float((f * ~llc_mask).sum() / total),
        master_cpu_share=float(cpu_out[0] / max(cpu_out.sum(), 1e-12)),
        gpu_llc_cv=float(
            np.std(f[C + M :, llcs].sum(axis=1)) / np.mean(f[C + M :, llcs].sum(axis=1))
        ),
    )
