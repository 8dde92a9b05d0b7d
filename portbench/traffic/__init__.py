"""Traffic of the benchmark's cells: the generator and the mixes.

A traffic mix is a data file ``traffic/<name>.json`` beside this module:
which optimizer a search runs, with which knobs and evaluation budget, on
the traffic of which paper applications (one name: that application's
matrix; several: their AVG, paper §6.4), the most designs one call into
the evaluator takes (``max_call``: a search checks its budget before each
call, so it may end up to one call's designs past it), and how many
searches make up its pool (``pool``). :func:`load_mix` reads it; a new mix
is a new file.

A search's work depends on its seed: the same budget takes 0.3 s on one
seed and 1.4 s on another. So every run of a mix runs the same pool of
searches, whose seeds are fixed, in an order drawn from the run's seed;
the run's seed also draws the evaluator answers that are checked.

The application matrices are a frozen copy of the port's generator of the
paper's Table 1 traffic (``repro_torch.core.traffic``), so that a change to
the program cannot move the benchmark's inputs; a CPU test holds the two
equal. The parametric generator reproduces the statistics of the paper's
§3 study: a master CPU core, near-uniform GPU <-> LLC traffic, more than
80% of the traffic touching an LLC.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

DIR = Path(__file__).resolve().parent

#: The keys every mix file holds.
MIX_KEYS = ("optimizer", "apps", "max_evals", "max_call", "pool", "config")

# Paper Table 1 applications: generator seed, injection intensity, LLC
# popularity skew, the master CPU's share, the CPU-LLC share of traffic.
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


def traffic_matrix(spec, app: str) -> np.ndarray:
    """(N, N) relative flit rates f[i, j] from core i to core j of ``app``
    on ``spec`` (anything with ``n_tiles``, ``n_cpu``, ``n_llc``,
    ``n_gpu``)."""
    p = APPLICATIONS[app]
    rng = np.random.default_rng(p["seed"] + 7919 * spec.n_tiles)
    n = spec.n_tiles
    C, M, G = spec.n_cpu, spec.n_llc, spec.n_gpu
    cpus = np.arange(0, C)
    llcs = np.arange(C, C + M)
    gpus = np.arange(C + M, n)

    f = np.zeros((n, n), dtype=np.float64)

    pop = rng.dirichlet(np.full(M, 1.0 / max(p["llc_skew"], 1e-3)))
    pop = 0.5 * pop + 0.5 / M

    # GPU <-> LLC: near-uniform many-to-few.
    gpu_w = 1.0 + 0.15 * rng.standard_normal(G).clip(-2, 2)
    gpu_w = np.maximum(gpu_w, 0.2)
    for gi, g in enumerate(gpus):
        for mi, m in enumerate(llcs):
            req = gpu_w[gi] * pop[mi]
            f[g, m] += req
            f[m, g] += 2.0 * req

    # CPU <-> LLC: the master core dominates.
    cpu_w = np.full(C, (1.0 - p["master_share"]) / max(C - 1, 1))
    cpu_w[0] = p["master_share"]
    for ci, c in enumerate(cpus):
        for mi, m in enumerate(llcs):
            req = cpu_w[ci] * pop[mi]
            f[c, m] += req
            f[m, c] += 2.0 * req

    # Little core-to-core traffic.
    for c in cpus:
        for g in gpus:
            t = rng.uniform(0.1, 0.5)
            f[c, g] += t
            f[g, c] += t
    for _ in range(G):
        a, b = rng.choice(gpus, size=2, replace=False)
        f[a, b] += rng.uniform(0.05, 0.2)

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

    core_share = 1.0 - rng.uniform(0.82, 0.93)
    cpu_frac = p["cpu_frac"]

    def _norm(x, target):
        s = x.sum()
        return x * (target / s) if s > 0 else x

    f = (_norm(gpu_llc, 1.0 - core_share - cpu_frac)
         + _norm(cpu_llc, cpu_frac)
         + _norm(core_core, core_share))
    return f * p["intensity"]


def avg_traffic(spec, apps: list[str]) -> np.ndarray:
    """AVG traffic (paper §6.4): each application's matrix scaled to unit
    sum, the mean of those, times the mean intensity."""
    mats = []
    for a in apps:
        m = traffic_matrix(spec, a)
        mats.append(m / m.sum())
    out = np.mean(mats, axis=0)
    return out * float(np.mean([APPLICATIONS[a]["intensity"] for a in apps]))


def load_mix(name: str, directory: Path = DIR) -> dict:
    """The traffic mix ``<directory>/<name>.json``, checked."""
    path = Path(directory) / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r}: {path} is missing")
    mix = json.loads(path.read_text())
    missing = [k for k in MIX_KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic mix {name!r} lacks {missing}")
    unknown = [a for a in mix["apps"] if a not in APPLICATIONS]
    if not mix["apps"] or unknown:
        raise ValueError(f"traffic mix {name!r}: unknown or no applications "
                         f"{unknown}")
    if int(mix["max_evals"]) < 1 or int(mix["pool"]) < 1:
        raise ValueError(f"traffic mix {name!r}: max_evals and pool must be "
                         ">= 1")
    return mix


def matrix(spec, mix: dict) -> np.ndarray:
    """The traffic matrix a mix's searches run on."""
    apps = list(mix["apps"])
    if len(apps) == 1:
        return traffic_matrix(spec, apps[0])
    return avg_traffic(spec, apps)


def search_seed(seed: int, i: int) -> int:
    """The ``i``-th seed drawn from ``seed``, in [0, 2**31); any whole
    number may be ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), int(i)])
    return int(ss.generate_state(1, np.uint32)[0]) & 0x7FFFFFFF


def pool(mix: dict) -> list[int]:
    """The seeds of the mix's searches, the same for every run."""
    return [search_seed(0, j) for j in range(1, int(mix["pool"]) + 1)]


def order(seed: int, n_pass: int, size: int) -> np.ndarray:
    """The order of a pool of ``size`` searches in pass ``n_pass`` of a
    run seeded ``seed``."""
    return np.random.default_rng(
        [int(seed) % (1 << 63), int(n_pass)]).permutation(size)
