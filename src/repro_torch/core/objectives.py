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
import itertools
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
T_AMBIENT = 45.0        # coolant/ambient reference (deg C), reporting only


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
    cost = torch.where(full_adj, c.router_stages + c.link_delay, routing.INF)
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


def _fixed_sum(x: torch.Tensor, dims: int) -> torch.Tensor:
    """Per-row sum of ``x`` over its last ``dims`` dimensions in one fixed
    order: the row, zero-padded to a power of two, is halved by pairwise
    adds until one term is left. The order depends on the row's length
    alone. PyTorch's CUDA reductions split a row across blocks according
    to how many rows there are, so their bits change with the batch: a
    design's objectives would differ between a batch and its chunks (the
    ``spmd`` split) or between two batch sizes."""
    x = x.reshape(*x.shape[:x.dim() - dims], -1)
    n = x.shape[-1]
    pad = (1 << max(0, (n - 1).bit_length())) - n
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


# ------------------------------------------------- the reference's order
# On the CPU the objective rows are bit-equal to the reference's: the walk
# accumulates util and visits in the order of its scatter-adds (hop step,
# then (src, dst) row-major), and every sum runs in XLA:CPU's order, which
# reduces a dimension of at most 32 strictly left to right and a longer one
# in windows of 32 (the dimension padded evenly on both sides to a multiple
# of 32), each window left to right, then the windows left to right. The
# card runs K4 and PyTorch's reductions; its rows agree to rounding.
_XLA_WINDOW = 32


def _seq_sum(x: np.ndarray) -> np.ndarray:
    """f32 sum over the last axis, left to right from +0."""
    z = np.zeros(x.shape[:-1] + (1,), np.float32)
    return np.add.accumulate(np.concatenate([z, x], axis=-1), axis=-1,
                             dtype=np.float32)[..., -1]


def _xla_sum(x: np.ndarray, nd: int) -> np.ndarray:
    """f32 sum over the last ``nd`` (1 or 2) axes in XLA:CPU's order."""
    lead, red = x.shape[:-nd], x.shape[-nd:]
    w = _XLA_WINDOW
    if all(n <= w for n in red):
        return _seq_sum(x.reshape(lead + (-1,)))
    pads = [(0, 0)] * len(lead)
    for n in red:
        tot = -n % w if n > w else 0
        pads.append((tot // 2, tot - tot // 2))
    x = np.pad(x, pads)
    win = [w if n > w else n for n in red]
    grid = [x.shape[len(lead) + d] // win[d] for d in range(nd)]
    split = lead + tuple(v for g, k in zip(grid, win) for v in (g, k))
    x = x.reshape(split)
    k = len(lead)
    if nd == 2:                      # (.., g0, w0, g1, w1) -> (.., g0, g1, w)
        x = x.transpose(*range(k), k, k + 2, k + 1, k + 3)
    parts = _seq_sum(x.reshape(lead + tuple(grid) + (-1,)))
    return _seq_sum(parts.reshape(lead + (-1,)))


def _walk_host_order(nh: torch.Tensor, delay: torch.Tensor, f: torch.Tensor,
                     max_hops: int):
    """The reference's walk (``repro.core.routing.walk_paths``) batched on
    the CPU, its scatter-adds in their order: index_add_ on a 1-D view adds
    in index order, (b, src, dst) row-major within each hop step."""
    bsz, n, _ = nh.shape
    nhl = nh.long()
    ar = torch.arange(n)
    dst = ar[None, None, :].expand(bsz, n, n)
    cur = ar[None, :, None].expand(bsz, n, n).clone()
    bidx = torch.arange(bsz)[:, None, None]
    hops = torch.zeros((bsz, n, n), dtype=torch.int32)
    dsum = torch.zeros((bsz, n, n), dtype=torch.float32)
    util = torch.zeros(bsz * n * n, dtype=torch.float32)
    visits = torch.zeros(bsz * n, dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32)
    for _ in range(max_hops):
        done = cur == dst
        nxt = nhl[bidx, cur, dst]
        w = torch.where(done, zero, f).reshape(-1)
        util.index_add_(0, ((bidx * n + cur) * n + nxt).reshape(-1), w)
        visits.index_add_(0, (bidx * n + cur).reshape(-1), w)
        dsum = dsum + torch.where(done, zero, delay[cur, nxt])
        hops += (~done).to(torch.int32)
        cur = torch.where(done, cur, nxt)
    all_done = (cur == dst).all(dim=2).all(dim=1)
    col = _xla_sum(f.numpy().transpose(0, 2, 1), 1)   # f.sum(axis=0)
    visits = visits.view(bsz, n) + torch.from_numpy(col)
    return hops, dsum, util.view(bsz, n, n), visits, all_done


def _tail_host_order(c: SpecConsts, full_adj, adj, f_slots, hops, delay,
                     util_d, visits, pair_cpu_llc, power_slot):
    """umean, ustd, lat, energy, temp and net_lat in the reference's
    operation and reduction order, in numpy f32."""
    f32 = np.float32
    full_adj, adj = full_adj.numpy(), adj.numpy()
    f_slots, util_d, visits = f_slots.numpy(), util_d.numpy(), visits.numpy()
    vadj, upper = c.vadj.numpy(), c.upper.numpy()
    zero = f32(0.0)

    path_lat = (c.router_stages * hops.numpy()).astype(f32) + delay.numpy()
    lat_terms = path_lat * f_slots
    lat = _xla_sum(np.where(pair_cpu_llc.numpy(), lat_terms, zero), 2) / f32(
        c.n_cpu * c.n_llc)

    util_u = util_d + util_d.transpose(0, 2, 1)
    link_mask = full_adj & upper
    umean = _xla_sum(np.where(link_mask, util_u, zero), 2) / f32(c.n_links)
    dev2 = (util_u - umean[:, None, None]) * (util_u - umean[:, None, None])
    uvar = _xla_sum(np.where(link_mask, dev2, zero), 2) / f32(c.n_links)
    ustd = np.sqrt(uvar + f32(1e-12))

    degree = (full_adj.sum(axis=2) + 1).astype(f32)
    e_router = f32(E_ROUTER_PORT) * _xla_sum(visits * degree, 1)
    planar = adj & ~vadj
    e_planar = f32(E_PLANAR_MM) * _xla_sum(
        np.where(planar, util_u * c.manhattan.numpy(), zero), 2) / f32(2.0)
    e_vert = f32(E_VERTICAL) * _xla_sum(
        np.where(vadj, util_u, zero), 2) / f32(2.0)
    energy = e_router + e_planar + e_vert

    bsz = f_slots.shape[0]
    p_stack = np.zeros((bsz, c.n_columns, c.n_layers), f32)
    p_stack[:, c.column.numpy(), c.layer.numpy()] = power_slot.numpy()
    i_idx = np.arange(1, c.n_layers + 1, dtype=f32)
    weighted = p_stack * (i_idx * f32(R_LAYER) + f32(R_BASE))[None, None, :]
    t_nk = np.empty_like(weighted)
    run = np.zeros(weighted.shape[:2], f32)
    for k in range(c.n_layers):                          # Eq. 5, in order
        run = run + weighted[:, :, k]
        t_nk[:, :, k] = run
    dT_k = t_nk.max(axis=1) - t_nk.min(axis=1)           # Eq. 6
    temp = t_nk.max(axis=(1, 2)) * dT_k.max(axis=1)      # Eq. 7

    total_f = _xla_sum(f_slots, 2) + f32(1e-12)
    net_lat = _xla_sum(path_lat * f_slots, 2) / total_f
    objs = np.stack([umean, ustd, lat, energy, temp], axis=1)
    return torch.from_numpy(objs), torch.from_numpy(net_lat)


def _tail_device(c: SpecConsts, full_adj, adj, f_slots, hops, delay,
                 util_d, visits, pair_cpu_llc, power_slot):
    """umean, ustd, lat, energy, temp and net_lat (Eqs. 1-10), every sum in
    :func:`_fixed_sum`'s order, so that a design's rows do not depend on
    the batch it is evaluated in."""
    bsz = f_slots.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=f_slots.device)
    path_lat = (c.router_stages * hops).float() + delay
    lat_f = path_lat * f_slots
    util_u = util_d + util_d.transpose(1, 2)
    link_mask = full_adj & c.upper
    planar = adj & ~c.vadj
    # The sums that need nothing but the walk, in one pass: Eq. 1's
    # CPU<->LLC latency, the links' utilization (Eq. 2), the planar and
    # vertical link energy terms (Eq. 10), and net_lat's two.
    sums = _fixed_sum(torch.stack([
        torch.where(pair_cpu_llc, lat_f, zero),
        torch.where(link_mask, util_u, zero),
        torch.where(planar, util_u * c.manhattan, zero),
        torch.where(c.vadj, util_u, zero),
        f_slots,
        lat_f,
    ], dim=1), 2)

    # ---- Eq. 1: CPU<->LLC latency ------------------------------------------
    lat = sums[:, 0] / (c.n_cpu * c.n_llc)

    # ---- Eqs. 2-4: link-utilization mean / std -----------------------------
    umean = sums[:, 1] / c.n_links
    dev2 = (util_u - umean[:, None, None]) ** 2
    uvar = _fixed_sum(torch.where(link_mask, dev2, zero), 2) / c.n_links
    ustd = torch.sqrt(uvar + 1e-12)

    # ---- Eqs. 8-10: energy --------------------------------------------------
    degree = full_adj.sum(dim=2) + 1                     # +1 local port
    e_router = E_ROUTER_PORT * _fixed_sum(visits * degree, 1)
    e_planar = E_PLANAR_MM * sums[:, 2] / 2.0
    e_vert = E_VERTICAL * sums[:, 3] / 2.0
    energy = e_router + e_planar + e_vert

    # ---- Eqs. 5-7: thermal --------------------------------------------------
    # Slots map to (column, layer) one to one: an index assignment, no
    # accumulating scatter.
    p_stack = torch.zeros((bsz, c.n_columns, c.n_layers), dtype=torch.float32,
                          device=f_slots.device)
    p_stack[:, c.column, c.layer] = power_slot
    i_idx = torch.arange(1, c.n_layers + 1, dtype=torch.float32,
                         device=f_slots.device)
    weighted = p_stack * (i_idx * R_LAYER + R_BASE)[None, None, :]
    # Eq. 5 (T_{n,k}): a running sum over the layers, in layer order.
    t_nk = torch.stack(list(itertools.accumulate(weighted.unbind(dim=2))),
                       dim=2)
    dT_k = t_nk.amax(dim=1) - t_nk.amin(dim=1)           # Eq. 6
    temp = t_nk.amax(dim=(1, 2)) * dT_k.amax(dim=1)      # Eq. 7
    objs = torch.stack([umean, ustd, lat, energy, temp], dim=1)

    # Network-wide average packet latency (all pairs, f-weighted) — the
    # paper's network-EDP metric (§6.1), not a search objective.
    net_lat = sums[:, 5] / (sums[:, 4] + 1e-12)
    return objs, net_lat


def evaluate_with_tables(c: SpecConsts, perm: torch.Tensor, adj: torch.Tensor,
                         f: torch.Tensor, dist: torch.Tensor,
                         nh: torch.Tensor):
    """Objectives of B designs given their routing tables (Eqs. 1-10).

    perm (B, N) int64 slot -> core id, adj (B, N, N) bool planar links,
    f (Ncores, Ncores) f32 traffic between cores, dist (B, N, N) f32,
    nh (B, N, N) int32. Returns ((B, 5) f32 objectives, INF rows for
    invalid designs; {"connected": (B,) bool, "net_lat": (B,) f32})."""
    full_adj = adj | c.vadj
    host = perm.device.type == "cpu"
    # Traffic between SLOTS under this placement.
    f_slots = f[perm[:, :, None], perm[:, None, :]] * (~c.eye).float()

    # ---- routing ---------------------------------------------------- Eq. 1
    walk = _walk_host_order if host else routing.walk_paths
    hops, delay, util_d, visits, all_done = walk(
        nh, c.link_delay, f_slots.contiguous(), c.max_hops)
    connected = (dist < routing.INF / 2).all(dim=2).all(dim=1) & all_done

    slot_type = c.core_types[perm]                       # (B, N)
    is_cpu = slot_type == 0
    is_llc = slot_type == 1
    pair_cpu_llc = ((is_cpu[:, :, None] & is_llc[:, None, :])
                    | (is_llc[:, :, None] & is_cpu[:, None, :]))
    power_slot = c.core_power[perm]                      # (B, N)
    if host:
        objs, net_lat = _tail_host_order(c, full_adj, adj, f_slots, hops,
                                         delay, util_d, visits, pair_cpu_llc,
                                         power_slot)
    else:
        objs, net_lat = _tail_device(c, full_adj, adj, f_slots, hops, delay,
                                     util_d, visits, pair_cpu_llc, power_slot)
    objs = torch.where(connected[:, None], objs, routing.INF)
    return objs, {"connected": connected, "net_lat": net_lat}


def peak_temperature_celsius(c: SpecConsts, perm: np.ndarray) -> float:
    """Reporting helper (Fig. 10c): peak core temperature in deg C, in host
    numpy over the consts of any device."""
    power_slot = c.core_power.cpu().numpy()[np.asarray(perm)]
    p = np.zeros((c.n_columns, c.n_layers))
    np.add.at(p, (c.column.cpu().numpy(), c.layer.cpu().numpy()), power_slot)
    i_idx = np.arange(1, c.n_layers + 1)
    t_nk = np.cumsum(p * (i_idx * R_LAYER + R_BASE)[None, :], axis=1)
    return float(T_AMBIENT + t_nk.max())
