"""Plain NumPy reference of the NoC design objectives (paper Eqs. 1-10).

A straightforward float64 implementation of the semantics the port computes
in float32 on the card: the 3D system's geometry, the hop costs of a
design, all-pairs shortest paths (Floyd-Warshall), first-index next hops,
the walk of every (source, destination) pair, link utilisation, and the
five objectives (mean and spread of link utilisation, CPU-LLC latency,
network energy, the thermal metric), plus the network latency of the
paper's EDP (§6.1). It imports nothing of the program.

``precision="bfloat16"`` rounds every intermediate array to bfloat16 (sums
accumulate wider and round their result, as a bfloat16 reduction on the
card does): the control that the benchmark's comparison must reject.
"""

from __future__ import annotations

import numpy as np

INF = 1.0e9

#: Objective order of every row.
OBJ_NAMES = ("umean", "ustd", "lat", "energy", "temp")

# Physical constants of the model (relative units).
E_ROUTER_PORT = 1.0     # router energy per flit per port, Eq. 8
E_PLANAR_MM = 0.6       # planar wire energy per flit per tile pitch, Eq. 9
E_VERTICAL = 0.3        # vertical link energy per flit, Eq. 9
R_LAYER = 0.25          # vertical thermal resistance per layer, Eq. 5
R_BASE = 2.0            # base-layer thermal resistance, Eq. 5
CORE_POWER = (2.0, 0.8, 3.0)   # CPU, LLC, GPU power (W), Eq. 5
CPU, LLC, GPU = 0, 1, 2

PRECISIONS = ("float64", "bfloat16")


def round_bf16(x) -> np.ndarray:
    """``x`` rounded to the nearest bfloat16 (ties to even), as float64."""
    a = np.ascontiguousarray(x, dtype=np.float32)
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def _rounder(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    if precision == "float64":
        return lambda x: np.asarray(x, dtype=np.float64)
    return round_bf16


class System:
    """A 3D heterogeneous manycore system: ``n_layers`` layers of ``nx`` x
    ``ny`` tiles. Slots are numbered layer-major, then row-major; core ids
    are grouped CPUs, LLCs, GPUs."""

    def __init__(self, nx: int, ny: int, n_layers: int, n_cpu: int,
                 n_llc: int, n_gpu: int, router_stages: int = 3,
                 max_hops: int = 24):
        self.nx, self.ny, self.n_layers = int(nx), int(ny), int(n_layers)
        self.n_cpu, self.n_llc, self.n_gpu = int(n_cpu), int(n_llc), int(n_gpu)
        self.router_stages = int(router_stages)
        self.max_hops = int(max_hops)
        n = self.n_tiles = self.nx * self.ny * self.n_layers
        if self.n_cpu + self.n_llc + self.n_gpu != n:
            raise ValueError(f"core counts {n_cpu}+{n_llc}+{n_gpu} != "
                             f"tiles {n}")
        tpl = self.nx * self.ny
        slot = np.arange(n)
        self.layer = slot // tpl
        self.x = (slot % tpl) // self.ny
        self.y = slot % self.ny
        self.column = self.x * self.ny + self.y
        self.n_columns = tpl
        self.n_planar_links = (self.nx * (self.ny - 1)
                               + self.ny * (self.nx - 1)) * self.n_layers
        self.n_links = self.n_planar_links + tpl * (self.n_layers - 1)
        eye = np.eye(n, dtype=bool)
        self.vadj = np.abs(slot[:, None] - slot[None, :]) == tpl
        self.planar_mask = (self.layer[:, None] == self.layer[None, :]) & ~eye
        self.manhattan = (np.abs(self.x[:, None] - self.x[None, :])
                          + np.abs(self.y[:, None] - self.y[None, :])
                          ).astype(np.float64)
        self.link_delay = np.where(self.vadj, 1.0,
                                   np.where(self.planar_mask,
                                            self.manhattan, 0.0))
        self.core_types = np.array([CPU] * self.n_cpu + [LLC] * self.n_llc
                                   + [GPU] * self.n_gpu)
        self.core_power = np.array([CORE_POWER[t] for t in self.core_types])

    def mesh(self) -> tuple[np.ndarray, np.ndarray]:
        """The 3D mesh: identity placement, each tile linked to its planar
        neighbours."""
        n = self.n_tiles
        adj = np.zeros((n, n), dtype=bool)
        s = np.arange(n)
        right = s[self.y + 1 < self.ny]
        down = s[self.x + 1 < self.nx]
        adj[right, right + 1] = adj[right + 1, right] = True
        adj[down, down + self.ny] = adj[down + self.ny, down] = True
        return np.arange(n), adj

    def design_faults(self, perm: np.ndarray, adj: np.ndarray) -> list[str]:
        """What makes a design invalid, by its structure alone: the
        placement must be a permutation of the cores, the planar links a
        symmetric set of same-layer pairs of the mesh's count."""
        n = self.n_tiles
        perm, adj = np.asarray(perm), np.asarray(adj)
        out = []
        if perm.shape != (n,) or not np.array_equal(np.sort(perm),
                                                    np.arange(n)):
            out.append("placement is not a permutation")
        if adj.shape != (n, n) or adj.dtype != bool:
            return out + ["adjacency is not an (N, N) boolean matrix"]
        if not np.array_equal(adj, adj.T):
            out.append("links are not symmetric")
        if (adj & ~self.planar_mask).any():
            out.append("a link joins two layers or a tile to itself")
        if int(np.triu(adj).sum()) != self.n_planar_links:
            out.append(f"{int(np.triu(adj).sum())} planar links, not "
                       f"{self.n_planar_links}")
        return out


def objectives(system: System, f: np.ndarray, perms, adjs, *,
               precision: str = "float64", block: int = 32):
    """Objective rows of designs ``(perms[b], adjs[b])`` under core-to-core
    traffic ``f``. Returns ``(objs (B, 5), net_lat (B,), valid (B,))``;
    a design whose paths do not all reach their destination within
    ``max_hops`` hops is invalid and gets an all-INF row."""
    perms = np.asarray(perms)
    adjs = np.asarray(adjs, dtype=bool)
    q = _rounder(precision)
    f = q(np.asarray(f, dtype=np.float64))
    outs = [_objectives_block(system, f, perms[i:i + block],
                              adjs[i:i + block], q)
            for i in range(0, perms.shape[0], block)]
    if not outs:
        return np.zeros((0, 5)), np.zeros((0,)), np.zeros((0,), bool)
    return tuple(np.concatenate(parts) for parts in zip(*outs))


def _shortest_paths(system: System, adj: np.ndarray, q):
    """Hop costs, Floyd-Warshall distances and first-index next hops of a
    (B, N, N) stack of link sets."""
    n = system.n_tiles
    eye = np.eye(n, dtype=bool)
    full = adj | system.vadj
    cost = q(np.where(full, system.router_stages + system.link_delay, INF))
    cost[:, eye] = 0.0
    dist = cost.copy()
    for k in range(n):
        np.minimum(dist, q(dist[:, :, k:k + 1] + dist[:, k:k + 1, :]),
                   out=dist)
    step = np.where(eye, INF, cost)
    # nh[b, i, j]: the first neighbour m minimising cost(i, m) + dist(m, j).
    nh = q(step[:, :, :, None] + dist[:, None, :, :]).argmin(axis=2)
    nh[:, eye] = np.arange(n)
    return full, dist, nh


def _walk(system: System, nh: np.ndarray, fs: np.ndarray):
    """Follow every pair's path for up to ``max_hops`` hops: hop counts,
    summed wire delay, directed link utilisation and router visits, each
    f-weighted where the paper weights it."""
    bsz, n, _ = nh.shape
    b = np.arange(bsz)[:, None, None]
    dst = np.broadcast_to(np.arange(n)[None, None, :], (bsz, n, n))
    cur = np.broadcast_to(np.arange(n)[None, :, None], (bsz, n, n)).copy()
    hops = np.zeros((bsz, n, n), dtype=np.int64)
    dsum = np.zeros((bsz, n, n))
    util = np.zeros(bsz * n * n)
    visits = np.zeros(bsz * n)
    for _ in range(system.max_hops):
        done = cur == dst
        if done.all():
            break
        nxt = nh[b, cur, dst]
        w = np.where(done, 0.0, fs)
        util += np.bincount(((b * n + cur) * n + nxt).ravel(), w.ravel(),
                            minlength=bsz * n * n)
        visits += np.bincount((b * n + cur).ravel(), w.ravel(),
                              minlength=bsz * n)
        dsum += np.where(done, 0.0, system.link_delay[cur, nxt])
        hops += ~done
        cur = np.where(done, cur, nxt)
    all_done = (cur == dst).all(axis=(1, 2))
    # Every flit also passes its destination's router.
    visits = visits.reshape(bsz, n) + fs.sum(axis=1)
    return hops, dsum, util.reshape(bsz, n, n), visits, all_done


def _objectives_block(system: System, f, perm, adj, q):
    bsz, n = perm.shape
    eye = np.eye(n, dtype=bool)
    full, dist, nh = _shortest_paths(system, adj, q)
    fs = q(f[perm[:, :, None], perm[:, None, :]] * ~eye)
    hops, dsum, util, visits, all_done = _walk(system, nh, fs)
    util, visits = q(util), q(visits)

    def total(x, axes=(1, 2)):
        return q(np.sum(x, axis=axes))

    path_lat = q(system.router_stages * hops + dsum)
    lat_f = q(path_lat * fs)
    util_u = q(util + util.transpose(0, 2, 1))
    link_mask = full & np.triu(np.ones((n, n), dtype=bool), 1)
    planar = adj & ~system.vadj
    slot_type = system.core_types[perm]
    is_cpu, is_llc = slot_type == CPU, slot_type == LLC
    cpu_llc = ((is_cpu[:, :, None] & is_llc[:, None, :])
               | (is_llc[:, :, None] & is_cpu[:, None, :]))

    # Eq. 1: CPU <-> LLC latency.
    lat = q(total(np.where(cpu_llc, lat_f, 0.0))
            / (system.n_cpu * system.n_llc))
    # Eqs. 2-4: mean and standard deviation of link utilisation.
    umean = q(total(np.where(link_mask, util_u, 0.0)) / system.n_links)
    dev2 = q(q(util_u - umean[:, None, None]) ** 2)
    uvar = q(total(np.where(link_mask, dev2, 0.0)) / system.n_links)
    ustd = q(np.sqrt(uvar + 1e-12))
    # Eqs. 8-10: router and link energy.
    degree = full.sum(axis=2) + 1
    e_router = q(E_ROUTER_PORT * total(q(visits * degree), 1))
    e_planar = q(E_PLANAR_MM * total(
        np.where(planar, q(util_u * system.manhattan), 0.0)) / 2.0)
    e_vert = q(E_VERTICAL * total(np.where(system.vadj, util_u, 0.0)) / 2.0)
    energy = q(q(e_router + e_planar) + e_vert)
    # Eqs. 5-7: per-column stack temperatures, layer by layer from the sink.
    p_stack = np.zeros((bsz, system.n_columns, system.n_layers))
    p_stack[:, system.column, system.layer] = system.core_power[perm]
    resist = q(np.arange(1, system.n_layers + 1) * R_LAYER + R_BASE)
    weighted = q(p_stack * resist)
    t_nk = np.empty_like(weighted)
    run = np.zeros(weighted.shape[:2])
    for k in range(system.n_layers):
        run = q(run + weighted[:, :, k])
        t_nk[:, :, k] = run
    d_t = q(t_nk.max(axis=1) - t_nk.min(axis=1))
    temp = q(t_nk.max(axis=(1, 2)) * d_t.max(axis=1))
    # Network latency of the paper's EDP: f-weighted over all pairs.
    net_lat = q(total(lat_f) / q(total(fs) + 1e-12))

    valid = (dist < INF / 2).all(axis=(1, 2)) & all_done
    objs = np.stack([umean, ustd, lat, energy, temp], axis=1)
    objs = np.where(valid[:, None], objs, INF)
    return objs, net_lat, valid
