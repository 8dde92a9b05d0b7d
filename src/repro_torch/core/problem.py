"""3D heterogeneous NoC design problem (paper §4).

A candidate design ``d`` is (paper §4.2.5):
  * a *tile placement* ``perm``: perm[slot] = core_id — which core sits at which
    3D grid slot, and
  * a *planar-link adjacency* ``adj``: a symmetric (N, N) boolean matrix holding
    exactly ``spec.n_planar_links`` intra-layer links (the link budget of the
    equivalent 3D mesh). Vertical TSV links are fixed by the geometry.

Neighbor moves (paper §5.1 / §6.2): swap two tiles (any layers), or reposition
exactly one planar link (to any other same-layer tile pair).

Core ids are grouped by type: CPUs ``[0, C)``, LLCs ``[C, C+M)``, GPUs
``[C+M, N)``. Layer ``k = 0`` is the layer closest to the heat sink.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property, lru_cache

import numpy as np

CPU, LLC, GPU = 0, 1, 2

# Per-core power (W) used by the thermal model (Eq. 5). 3D-ICE/McPAT are not
# available offline; these follow the paper's qualitative ordering (GPUs are
# the high-power cores, LLCs the coolest — §6.5).
CORE_POWER = {CPU: 2.0, LLC: 0.8, GPU: 3.0}


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """Static description of a 3D heterogeneous manycore system."""

    nx: int
    ny: int
    n_layers: int
    n_cpu: int
    n_llc: int
    n_gpu: int
    router_stages: int = 3          # paper §6.1: standard three-stage router
    max_hops: int = 24              # path-walk bound; designs needing more are invalid

    def __post_init__(self):
        if self.n_cpu + self.n_llc + self.n_gpu != self.n_tiles:
            raise ValueError(
                f"core counts {self.n_cpu}+{self.n_llc}+{self.n_gpu} != "
                f"tiles {self.n_tiles}"
            )

    # ---------------------------------------------------------------- sizes
    @property
    def n_tiles(self) -> int:
        return self.nx * self.ny * self.n_layers

    @property
    def tiles_per_layer(self) -> int:
        return self.nx * self.ny

    @property
    def n_planar_links(self) -> int:
        """Link budget = planar links of the same-size 3D mesh (paper §4.2.5)."""
        return (self.nx * (self.ny - 1) + self.ny * (self.nx - 1)) * self.n_layers

    @property
    def n_vertical_links(self) -> int:
        return self.tiles_per_layer * (self.n_layers - 1)

    @property
    def n_links(self) -> int:
        return self.n_planar_links + self.n_vertical_links

    # ----------------------------------------------------------- geometry
    @cached_property
    def coords(self) -> np.ndarray:
        """(N, 3) int array of (layer, x, y) per slot. Slot index is
        layer-major then row-major: slot = k * nx * ny + x * ny + y."""
        out = np.zeros((self.n_tiles, 3), dtype=np.int32)
        s = 0
        for k in range(self.n_layers):
            for x in range(self.nx):
                for y in range(self.ny):
                    out[s] = (k, x, y)
                    s += 1
        return out

    @cached_property
    def layer_of_slot(self) -> np.ndarray:
        return self.coords[:, 0].copy()

    @cached_property
    def vertical_adj(self) -> np.ndarray:
        """(N, N) bool — fixed TSV links between vertically adjacent slots."""
        n = self.n_tiles
        v = np.zeros((n, n), dtype=bool)
        tpl = self.tiles_per_layer
        for s in range(n - tpl):
            v[s, s + tpl] = v[s + tpl, s] = True
        return v

    @cached_property
    def planar_pair_mask(self) -> np.ndarray:
        """(N, N) bool — slot pairs that MAY carry a planar link (same layer).

        The paper places no regularity constraint: any same-layer pair is a
        legal planar link (long links cost more delay/energy — Eqs. 1, 9)."""
        same_layer = self.layer_of_slot[:, None] == self.layer_of_slot[None, :]
        return same_layer & ~np.eye(self.n_tiles, dtype=bool)

    @cached_property
    def manhattan(self) -> np.ndarray:
        """(N, N) float planar Manhattan distance (tile pitches) per slot pair."""
        c = self.coords[:, 1:].astype(np.float64)
        return np.abs(c[:, None, :] - c[None, :, :]).sum(-1)

    @cached_property
    def link_delay(self) -> np.ndarray:
        """(N, N) per-hop wire delay d (cycles): planar = Manhattan length,
        vertical TSV = 1 (TSVs are short/fast — paper §1)."""
        d = np.where(self.planar_pair_mask, self.manhattan, 0.0)
        d = np.where(self.vertical_adj, 1.0, d)
        return d.astype(np.float64)

    # --------------------------------------------------------------- cores
    @cached_property
    def core_types(self) -> np.ndarray:
        """(N,) int — type of core id i (ids grouped CPU | LLC | GPU)."""
        return np.array(
            [CPU] * self.n_cpu + [LLC] * self.n_llc + [GPU] * self.n_gpu,
            dtype=np.int32,
        )

    @cached_property
    def core_power(self) -> np.ndarray:
        return np.array([CORE_POWER[t] for t in self.core_types], dtype=np.float64)

    # ------------------------------------------------------ initial design
    def mesh_design(self) -> "Design":
        """The 3D-mesh starting design (paper §6.3: all searches start from a
        3D mesh with uniformly distributed links)."""
        n = self.n_tiles
        adj = np.zeros((n, n), dtype=bool)
        for s in range(n):
            k, x, y = self.coords[s]
            if y + 1 < self.ny:
                adj[s, s + 1] = adj[s + 1, s] = True
            if x + 1 < self.nx:
                adj[s, s + self.ny] = adj[s + self.ny, s] = True
        n_links = int(np.triu(adj).sum())
        if n_links != self.n_planar_links:
            raise RuntimeError(
                f"mesh link budget mismatch: built {n_links}, "
                f"expected {self.n_planar_links}")
        return Design(perm=np.arange(n, dtype=np.int32), adj=adj)


# Paper's two evaluation systems (§6.1, §6.4).
def spec_64() -> SystemSpec:
    """64 tiles: 8 CPUs, 16 LLCs, 40 GPUs in four 4x4 layers."""
    return SystemSpec(nx=4, ny=4, n_layers=4, n_cpu=8, n_llc=16, n_gpu=40)


def spec_36() -> SystemSpec:
    """36 tiles: 4 CPUs, 8 LLCs, 24 GPUs in four 3x3 layers."""
    return SystemSpec(nx=3, ny=3, n_layers=4, n_cpu=4, n_llc=8, n_gpu=24)


def spec_tiny() -> SystemSpec:
    """8 tiles (two 2x2 layers): 1 CPU, 2 LLCs, 5 GPUs — for tests/PCBB."""
    return SystemSpec(nx=2, ny=2, n_layers=2, n_cpu=1, n_llc=2, n_gpu=5, max_hops=8)


def spec_16() -> SystemSpec:
    """16 tiles (two 2x4 layers): 2 CPUs, 4 LLCs, 10 GPUs — small benches."""
    return SystemSpec(nx=2, ny=4, n_layers=2, n_cpu=2, n_llc=4, n_gpu=10, max_hops=12)


# Scale tiers beyond the paper (ROADMAP "scale the design space"): the
# CPU/LLC/GPU mix keeps the paper's 1:2:5 ratio; max_hops grows with the
# network diameter (path-walk bound, not a routing constraint).
def spec_large() -> SystemSpec:
    """256 tiles: 32 CPUs, 64 LLCs, 160 GPUs in four 8x8 layers — the
    interactive-speed target of the incremental delta evaluator."""
    return SystemSpec(nx=8, ny=8, n_layers=4, n_cpu=32, n_llc=64, n_gpu=160,
                      max_hops=48)


def spec_1024() -> SystemSpec:
    """1024 tiles: 128 CPUs, 256 LLCs, 640 GPUs in four 16x16 layers — the
    stretch tier; exercises the k-blocked dense path (memory-safe APSP)."""
    return SystemSpec(nx=16, ny=16, n_layers=4, n_cpu=128, n_llc=256,
                      n_gpu=640, max_hops=96)


@dataclasses.dataclass
class Design:
    """A candidate design: tile placement + planar link adjacency."""

    perm: np.ndarray   # (N,) int32, perm[slot] = core id
    adj: np.ndarray    # (N, N) bool, symmetric planar links

    def copy(self) -> "Design":
        return Design(self.perm.copy(), self.adj.copy())

    def key(self) -> bytes:
        """Hashable identity (used for de-dup in search trajectories)."""
        return self.perm.tobytes() + np.packbits(self.adj).tobytes()

    # ------------------------------------------------------------- moves
    # Move validation raises real exceptions (not ``assert``): asserts are
    # stripped under ``python -O``, which would let an invalid move silently
    # corrupt the link budget / placement permutation.
    def swap_tiles(self, a: int, b: int) -> "Design":
        if a == b:
            raise ValueError(f"swap_tiles: slots must differ, got {a} twice")
        d = self.copy()
        d.perm[a], d.perm[b] = d.perm[b], d.perm[a]
        return d

    def move_link(self, rem: tuple[int, int], add: tuple[int, int]) -> "Design":
        d = self.copy()
        (a, b), (c, e) = rem, add
        if a == b or c == e:
            raise ValueError(f"move_link: self-links are invalid "
                             f"(rem={rem}, add={add})")
        if not d.adj[a, b]:
            raise ValueError(f"move_link: removing non-existent link {rem}")
        d.adj[a, b] = d.adj[b, a] = False
        if d.adj[c, e]:
            raise ValueError(f"move_link: adding already-present link {add}")
        d.adj[c, e] = d.adj[e, c] = True
        return d


@lru_cache(maxsize=16)
def _triu_pairs(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Cached upper-triangle index pair (iu0, iu1) for an n-tile spec."""
    iu = np.triu_indices(n, 1)
    return iu[0], iu[1]


@lru_cache(maxsize=16)
def _planar_pair_row(spec: SystemSpec) -> np.ndarray:
    """Cached ``spec.planar_pair_mask`` over the upper triangle, in
    ``_triu_pairs`` order: the row form of a design's planar links."""
    iu0, iu1 = _triu_pairs(spec.n_tiles)
    row = spec.planar_pair_mask[iu0, iu1]
    row.flags.writeable = False
    return row


def existing_planar_links(spec: SystemSpec, adj: np.ndarray) -> list[tuple[int, int]]:
    iu0, iu1 = _triu_pairs(spec.n_tiles)
    mask = adj[iu0, iu1]
    return list(zip(iu0[mask].tolist(), iu1[mask].tolist()))


def absent_planar_pairs(spec: SystemSpec, adj: np.ndarray) -> list[tuple[int, int]]:
    iu0, iu1 = _triu_pairs(spec.n_tiles)
    ok = spec.planar_pair_mask[iu0, iu1] & ~adj[iu0, iu1]
    return list(zip(iu0[ok].tolist(), iu1[ok].tolist()))


@dataclasses.dataclass
class NeighborMoves:
    """A sampled neighborhood in *move* form: every candidate is the base
    design plus exactly one move (a tile swap or a single-link reposition).

    The fused meta-search (core.fused) scores the whole neighborhood on
    device from this representation — (B, 2) move index arrays instead of B
    materialized ``Design`` objects with their (N, N) adjacency copies — and
    only the argmax winner is ever materialized. ``materialize_all`` is the
    legacy form; :func:`sample_neighbors` is exactly that, so move-order and
    rng-stream parity between the two paths is structural, not tested-for."""

    base: Design
    swaps: np.ndarray      # (S, 2) int32 slot pairs, candidate i = swap i
    rem: np.ndarray        # (L, 2) int32 removed link endpoints (triu order)
    add: np.ndarray        # (L, 2) int32 added link endpoints (triu order)

    def __len__(self) -> int:
        return self.swaps.shape[0] + self.rem.shape[0]

    def materialize(self, j: int) -> Design:
        """Build candidate ``j`` (same order as :func:`sample_neighbors`:
        swaps first, then link moves) — with full move validation."""
        s = self.swaps.shape[0]
        if j < s:
            return self.base.swap_tiles(int(self.swaps[j, 0]),
                                        int(self.swaps[j, 1]))
        k = j - s
        return self.base.move_link(
            (int(self.rem[k, 0]), int(self.rem[k, 1])),
            (int(self.add[k, 0]), int(self.add[k, 1])))

    def materialize_all(self) -> list[Design]:
        return [self.materialize(j) for j in range(len(self))]

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """``(perms (B, N), adjs (B, N, N) bool)`` of all candidates in
        ``materialize`` order: the stacked fields of :meth:`materialize_all`,
        built by fancy indexing with no per-candidate ``Design``. The moves
        are checked as ``materialize`` checks them, all at once: a swap of a
        slot with itself, a self-link, a removed link that is absent or an
        added link that is present (after the removal) raise
        ``ValueError``."""
        s, n = self.swaps.shape[0], len(self)
        perms = np.repeat(self.base.perm[None], n, axis=0)
        adjs = np.repeat(self.base.adj[None], n, axis=0)
        r = np.arange(s)
        a, b = self.swaps.T
        if (a == b).any():
            raise ValueError(f"swap_tiles: slots must differ, got "
                             f"{self.swaps[a == b][0].tolist()}")
        perms[r, a], perms[r, b] = self.base.perm[b], self.base.perm[a]
        r = np.arange(s, n)
        (a, b), (c, e) = self.rem.T, self.add.T
        same = ((a == c) & (b == e)) | ((a == e) & (b == c))
        bad = ((a == b) | (c == e) | ~self.base.adj[a, b]
               | (self.base.adj[c, e] & ~same))
        if bad.any():
            k = int(np.flatnonzero(bad)[0])
            raise ValueError(f"move_link: invalid move rem="
                             f"{tuple(self.rem[k].tolist())}, "
                             f"add={tuple(self.add[k].tolist())}")
        adjs[r, a, b] = adjs[r, b, a] = False
        adjs[r, c, e] = adjs[r, e, c] = True
        return perms, adjs


def draw_neighbor_moves(
    spec: SystemSpec,
    perm: np.ndarray,
    links: np.ndarray,
    rng: np.random.Generator,
    n_swaps: int,
    n_link_moves: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The neighborhood sampler's draws for placement ``perm`` and planar
    links ``links``, a (N(N-1)/2,) bool upper-triangle row in
    ``_triu_pairs`` order: ``(swaps, ri, ai)`` — (S, 2) int32 slot pairs,
    then per link move the row index of the link removed (``ri``) and of
    the hole filled (``ai``). The one place the draws are made, for
    :func:`sample_neighbor_moves` and NSGA-II's mutation alike."""
    n = spec.n_tiles
    # Uniform ordered distinct pairs, drawn in one vectorized shot (the
    # same per-pair distribution as choice(n, 2, replace=False), without
    # n_swaps generator round-trips — the sampler is on the fused meta
    # step's critical path). No-op swaps (identical core ids) are skipped,
    # as before.
    a = rng.integers(0, n, size=n_swaps)
    b = rng.integers(0, n - 1, size=n_swaps)
    b = b + (b >= a)
    keep = perm[a] != perm[b]
    swaps = np.stack([a[keep], b[keep]], axis=1).astype(np.int32)
    link_idx = np.flatnonzero(links)
    hole_idx = np.flatnonzero(_planar_pair_row(spec) & ~links)
    ri = ai = np.zeros(0, np.intp)
    if link_idx.size and hole_idx.size:
        ri = link_idx[rng.integers(0, link_idx.size, size=n_link_moves)]
        ai = hole_idx[rng.integers(0, hole_idx.size, size=n_link_moves)]
    return swaps.reshape(-1, 2), ri, ai


def sample_neighbor_moves(
    spec: SystemSpec,
    d: Design,
    rng: np.random.Generator,
    n_swaps: int,
    n_link_moves: int,
) -> NeighborMoves:
    """Sample a neighborhood as :class:`NeighborMoves` (no ``Design``
    construction). This IS the neighborhood sampler — ``sample_neighbors``
    materializes its output — so the same (rng state, base, knobs) yields
    the same candidates in the same order under either representation."""
    iu0, iu1 = _triu_pairs(spec.n_tiles)
    swaps, ri, ai = draw_neighbor_moves(
        spec, d.perm, d.adj[iu0, iu1].astype(bool), rng, n_swaps,
        n_link_moves)
    rem = np.stack([iu0[ri], iu1[ri]], axis=1).astype(np.int32)
    add = np.stack([iu0[ai], iu1[ai]], axis=1).astype(np.int32)
    return NeighborMoves(base=d, swaps=swaps, rem=rem, add=add)


def sample_neighbors(
    spec: SystemSpec,
    d: Design,
    rng: np.random.Generator,
    n_swaps: int,
    n_link_moves: int,
) -> list[Design]:
    """Sample neighbor designs: tile swaps + single-planar-link repositions.

    The paper's greedy step evaluates the full neighborhood; that is O(N^2)
    swaps + O(L * P) link moves. We evaluate a uniform sample per step (the
    sample size is a knob; with n large enough the argmax matches the full
    neighborhood with high probability) — all candidates are scored in ONE
    batched evaluator call."""
    return sample_neighbor_moves(spec, d, rng, n_swaps, n_link_moves
                                 ).materialize_all()


def all_neighbors(spec: SystemSpec, d: Design) -> list[Design]:
    """Full neighborhood (exact Alg. 1 argmax) — only viable for small specs."""
    out = []
    n = spec.n_tiles
    for a in range(n):
        for b in range(a + 1, n):
            if d.perm[a] != d.perm[b]:
                out.append(d.swap_tiles(a, b))
    links = existing_planar_links(spec, d.adj)
    holes = absent_planar_pairs(spec, d.adj)
    for r in links:
        for h in holes:
            out.append(d.move_link(r, h))
    return out


def random_design(spec: SystemSpec, rng: np.random.Generator) -> Design:
    """Uniform random valid design (random restart / rand(D) in Alg. 2)."""
    perm = rng.permutation(spec.n_tiles).astype(np.int32)
    iu = _triu_pairs(spec.n_tiles)
    cand = np.flatnonzero(spec.planar_pair_mask[iu])
    pick = rng.choice(cand, size=spec.n_planar_links, replace=False)
    adj = np.zeros((spec.n_tiles, spec.n_tiles), dtype=bool)
    adj[iu[0][pick], iu[1][pick]] = True
    return Design(perm=perm, adj=adj | adj.T)
