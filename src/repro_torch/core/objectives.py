"""Analytical design objectives — Eqs. 1-10 of the paper, batched over
designs in PyTorch.

Five objectives, all minimized (paper Eq. 11):

    index 0  umean  — mean expected link utilization, Eq. 3   (throughput proxy)
    index 1  ustd   — std of link utilization,        Eq. 4   (throughput proxy)
    index 2  lat    — average CPU<->LLC latency,      Eq. 1
    index 3  energy — router + link energy,           Eqs. 8-10
    index 4  temp   — thermal metric T,               Eqs. 5-7

The physical constants are the reference's documented stand-ins
(``repro.core.objectives``); the arithmetic is the reference's, in f32, with
a batch dimension in front of every per-design array.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import routing
from .problem import SystemSpec

OBJ_NAMES = ("umean", "ustd", "lat", "energy", "temp")
N_OBJ = len(OBJ_NAMES)

# Optimization cases (paper §6.2 and §6.5), as objective-index tuples.
CASES: dict[str, tuple[int, ...]] = {
    "case1": (0, 1),            # {U, sigma}
    "case2": (0, 1, 2),         # + Lat
    "case3": (0, 1, 2, 3),      # + E        ("network efficiency / perf")
    "case4": (4,),              # {T}        (thermal-only)
    "case5": (0, 1, 2, 3, 4),   # + T        (joint perf-thermal)
}

# ----------------------------------------------------------------- constants
E_ROUTER_PORT = 1.0     # router logic energy per flit per port (rel. pJ), Eq. 8
E_PLANAR_MM = 0.6       # planar wire energy per flit per tile pitch,     Eq. 9
E_VERTICAL = 0.3        # TSV energy per flit,                            Eq. 9
R_LAYER = 0.25          # vertical thermal resistance R_j (K/W),          Eq. 5
R_BASE = 2.0            # base-layer thermal resistance R_b (K/W),        Eq. 5


class SpecConsts(NamedTuple):
    """Static per-spec tensors on one device."""

    vadj: torch.Tensor         # (N, N) bool vertical links
    link_delay: torch.Tensor   # (N, N) f32 wire delay
    manhattan: torch.Tensor    # (N, N) f32 planar length
    core_types: torch.Tensor   # (Ncores,) int64
    core_power: torch.Tensor   # (Ncores,) f32
    column: torch.Tensor       # (N,) column (single-tile-stack) id per slot
    layer: torch.Tensor        # (N,) layer id per slot (0 = at the sink)
    eye: torch.Tensor          # (N, N) bool
    upper: torch.Tensor        # (N, N) bool strict upper triangle
    n_cpu: int
    n_llc: int
    router_stages: int
    max_hops: int
    n_links: int
    apsp_iters: int
    n_columns: int
    n_layers: int


@functools.lru_cache(maxsize=64)
def make_consts(spec: SystemSpec, device: str) -> SpecConsts:
    col = spec.coords[:, 1] * spec.ny + spec.coords[:, 2]
    n = spec.n_tiles

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    eye = torch.eye(n, dtype=torch.bool, device=device)
    return SpecConsts(
        vadj=t(spec.vertical_adj, torch.bool),
        link_delay=t(spec.link_delay.astype(np.float32), torch.float32),
        manhattan=t(spec.manhattan.astype(np.float32), torch.float32),
        core_types=t(spec.core_types, torch.int64),
        core_power=t(spec.core_power.astype(np.float32), torch.float32),
        column=t(col, torch.int64),
        layer=t(spec.layer_of_slot, torch.int64),
        eye=eye,
        upper=torch.ones((n, n), dtype=torch.bool, device=device).triu(1),
        n_cpu=spec.n_cpu,
        n_llc=spec.n_llc,
        router_stages=spec.router_stages,
        max_hops=spec.max_hops,
        n_links=spec.n_links,
        apsp_iters=routing.apsp_iters(spec.n_tiles),
        n_columns=spec.tiles_per_layer,
        n_layers=spec.n_layers,
    )


def design_cost(c: SpecConsts, adj: torch.Tensor) -> torch.Tensor:
    """(B, N, N) f32 hop-cost matrices: router pipeline + wire delay on
    present links, INF on absent ones, 0 on the diagonal."""
    full_adj = adj | c.vadj
    cost = torch.where(full_adj, c.router_stages + c.link_delay,
                       torch.tensor(routing.INF, device=adj.device))
    return cost.masked_fill(c.eye, 0.0)


def design_cost_np(spec: SystemSpec, adj: np.ndarray) -> np.ndarray:
    """Host twin of :func:`design_cost` — bit-identical f32 hop costs (the
    entries are small integers, exact in f32 on both paths)."""
    full_adj = np.asarray(adj, dtype=bool) | spec.vertical_adj
    cost = np.where(
        full_adj,
        np.float32(spec.router_stages) + spec.link_delay.astype(np.float32),
        np.float32(routing.INF),
    ).astype(np.float32)
    np.fill_diagonal(cost, np.float32(0.0))
    return cost


def _masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-design sum of ``x`` over ``mask`` (zeros elsewhere)."""
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device)).sum(dim=(1, 2))


def evaluate_with_tables(c: SpecConsts, perm: torch.Tensor, adj: torch.Tensor,
                         f: torch.Tensor, dist: torch.Tensor,
                         nh: torch.Tensor):
    """Objectives of B designs given their routing tables (Eqs. 1-10).

    perm (B, N) int64 slot -> core id, adj (B, N, N) bool planar links,
    f (Ncores, Ncores) f32 traffic between cores, dist (B, N, N) f32,
    nh (B, N, N) int32. Returns ((B, 5) f32 objectives, INF rows for
    invalid designs; {"connected": (B,) bool, "net_lat": (B,) f32})."""
    bsz, n = perm.shape
    full_adj = adj | c.vadj
    # Traffic between SLOTS under this placement.
    f_slots = f[perm[:, :, None], perm[:, None, :]] * (~c.eye).float()

    # ---- routing ---------------------------------------------------- Eq. 1
    hops, delay, util_d, visits, all_done = routing.walk_paths(
        nh, c.link_delay, f_slots.contiguous(), c.max_hops)
    connected = (dist < routing.INF / 2).all(dim=2).all(dim=1) & all_done

    # ---- Eq. 1: CPU<->LLC latency ------------------------------------------
    slot_type = c.core_types[perm]                       # (B, N)
    is_cpu = slot_type == 0
    is_llc = slot_type == 1
    pair_cpu_llc = ((is_cpu[:, :, None] & is_llc[:, None, :])
                    | (is_llc[:, :, None] & is_cpu[:, None, :]))
    path_lat = (c.router_stages * hops).float() + delay
    lat_terms = path_lat * f_slots
    lat = _masked_sum(lat_terms, pair_cpu_llc) / (c.n_cpu * c.n_llc)

    # ---- Eqs. 2-4: link-utilization mean / std -----------------------------
    util_u = util_d + util_d.transpose(1, 2)
    link_mask = full_adj & c.upper
    umean = _masked_sum(util_u, link_mask) / c.n_links
    dev2 = (util_u - umean[:, None, None]) ** 2
    uvar = _masked_sum(dev2, link_mask) / c.n_links
    ustd = torch.sqrt(uvar + 1e-12)

    # ---- Eqs. 8-10: energy --------------------------------------------------
    degree = full_adj.sum(dim=2) + 1                     # +1 local port
    e_router = E_ROUTER_PORT * (visits * degree).sum(dim=1)
    planar = adj & ~c.vadj
    e_planar = E_PLANAR_MM * _masked_sum(util_u * c.manhattan, planar) / 2.0
    e_vert = E_VERTICAL * _masked_sum(util_u, c.vadj.expand(bsz, n, n)) / 2.0
    energy = e_router + e_planar + e_vert

    # ---- Eqs. 5-7: thermal --------------------------------------------------
    # Slots map to (column, layer) one to one: an index assignment, no
    # accumulating scatter.
    power_slot = c.core_power[perm]                      # (B, N)
    p_stack = torch.zeros((bsz, c.n_columns, c.n_layers), dtype=torch.float32,
                          device=perm.device)
    p_stack[:, c.column, c.layer] = power_slot
    i_idx = torch.arange(1, c.n_layers + 1, dtype=torch.float32,
                         device=perm.device)
    weighted = p_stack * (i_idx * R_LAYER + R_BASE)[None, None, :]
    t_nk = torch.cumsum(weighted, dim=2)                 # Eq. 5 (T_{n,k})
    dT_k = t_nk.amax(dim=1) - t_nk.amin(dim=1)           # Eq. 6
    temp = t_nk.amax(dim=(1, 2)) * dT_k.amax(dim=1)      # Eq. 7

    objs = torch.stack([umean, ustd, lat, energy, temp], dim=1)
    objs = torch.where(connected[:, None], objs,
                       torch.tensor(routing.INF, device=objs.device))

    # Network-wide average packet latency (all pairs, f-weighted) — the
    # paper's network-EDP metric (§6.1), not a search objective.
    total_f = f_slots.sum(dim=(1, 2)) + 1e-12
    net_lat = (path_lat * f_slots).sum(dim=(1, 2)) / total_f
    return objs, {"connected": connected, "net_lat": net_lat}

