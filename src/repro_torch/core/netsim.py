"""Flit-level network simulator — the Garnet stand-in, in host numpy.

Plays the role the paper assigns to cycle-accurate simulation (§4.2.2,
§6.1): an *independent* measurement of network throughput/latency used to
(a) validate the Ū/σ link-utilization throughput proxy (Fig. 4) and
(b) provide the "detailed simulation" latency in network-EDP numbers.

Model: single-flit packets; each directed link forwards 1 flit/cycle;
per-link FIFO queues; deterministic next-hop routing from core/routing
(the same tables the analytical objectives use); Bernoulli/Poisson
injection proportional to the application traffic matrix. Wormhole/VC
effects are abstracted away — saturation behaviour and relative ordering of
designs are what matter here, not absolute cycle counts.

Two engines implement the same cycle semantics:

  * :func:`simulate_batch` / :func:`simulate` — the production engine.
    Struct-of-arrays: every directed link is an edge index into flat ring
    buffers (one packed int64 per flit), and each cycle advances ALL edges
    of ALL batched simulations with a handful of NumPy ops. A batch is the
    cross product designs × injection scales × seeds, so next-hop tables
    (cached per (spec, design) — see :func:`_next_hops`) and the cycle loop
    are amortized across the whole sweep.
  * :func:`simulate_reference` — the original per-cycle, per-edge Python
    dict/deque loop, kept as the executable specification. The golden
    equivalence tests (tests/test_netsim.py) pin the vectorized engine to
    it: same seed -> identical delivered counts and latency statistics.

Enqueue ordering matches the reference loop exactly: within one cycle,
forwarded flits enter their target queue in source-edge order (edges sorted
by (a, b)), followed by freshly injected flits in draw order.

The simulator never touches a device: its routing tables come from the
host mirrors ``routing.apsp_np`` / ``routing.next_hop_np``, bit-equal to
the device tables the evaluator builds.
"""

from __future__ import annotations

from collections import OrderedDict, deque

import numpy as np

from . import routing as _routing
from .routing import apsp_iters
from .problem import Design, SystemSpec

INF = 1.0e9

# --------------------------------------------------------------------------
# Next-hop tables (host-side NumPy, float32 to mirror the device tables)
# --------------------------------------------------------------------------

# LRU cache of routing tables keyed by (spec, design identity). Saves the
# per-injection-scale (and per-seed) APSP rebuild that used to dominate
# ``saturation_throughput`` — the tables only depend on (spec, design).
# Bounded by accumulated BYTES, not entry count: each entry holds O(N²)
# arrays ((N, N) int64 edge_id alone is 128 MiB at 4096 tiles), so a
# count-only bound silently grows unbounded with N. The count bound stays
# as a backstop for tiny specs.
_NH_CACHE: "OrderedDict[tuple, dict]" = OrderedDict()
_NH_CACHE_MAX = 512
_NH_CACHE_MAX_BYTES = 256 << 20
_nh_cache_nbytes = 0


def clear_caches() -> None:
    """Drop cached routing tables (tests / memory pressure)."""
    global _nh_cache_nbytes
    _NH_CACHE.clear()
    _nh_cache_nbytes = 0


def _apsp_np(cost: np.ndarray, n_iters: int) -> np.ndarray:
    """Batched (D, N, N) APSP, float32 NumPy — delegates per design to
    routing.apsp_np (k-blocked min-plus squaring): bit-equal to the device
    oracle AND to the historical (D, N, N, N) broadcast here, without its
    N³ transient (memory-safe at 1024+ tiles)."""
    return np.stack([_routing.apsp_np(c, n_iters) for c in cost])


def _tables_np(cost: np.ndarray, n_iters: int):
    """(dist, next_hop) for a (D, N, N) stack of hop-cost matrices."""
    dist = _apsp_np(cost, n_iters)
    nh = np.stack([_routing.next_hop_np(c, dd)
                   for c, dd in zip(cost, dist)])
    return dist, nh


def _design_tables(spec: SystemSpec, d: Design) -> dict:
    """Cached routing/edge tables for the engine. Keyed on the link
    topology only — placement (perm) moves don't change the tables, so
    swap-move trajectories all hit one entry."""
    key = (spec, np.packbits(d.adj).tobytes())
    hit = _NH_CACHE.get(key)
    if hit is not None:
        _NH_CACHE.move_to_end(key)
        return hit
    n = spec.n_tiles
    full_adj = d.adj | spec.vertical_adj
    # Pure-NumPy mirror of objectives.make_consts' routing inputs: keeps the
    # host-side simulator free of JAX dispatch/compile latency.
    link_delay = spec.link_delay.astype(np.float32)
    cost = np.where(full_adj, np.float32(spec.router_stages) + link_delay,
                    np.float32(INF))
    np.fill_diagonal(cost, 0.0)
    dist, nh = _tables_np(cost[None], apsp_iters(n))
    nh = nh[0]
    # Directed edge list in (a, b) row-major order — the reference loop's
    # dict insertion order, which fixes intra-cycle enqueue ordering.
    ea, eb = np.nonzero(full_adj)
    edge_id = np.full((n, n), -1, dtype=np.int64)
    edge_id[ea, eb] = np.arange(ea.size)
    entry = dict(nh=nh, edge_b=eb.astype(np.int64), edge_id=edge_id,
                 n_edges=int(ea.size), reach=dist[0] < INF / 2)
    entry["nbytes"] = sum(v.nbytes for v in entry.values()
                          if isinstance(v, np.ndarray))
    global _nh_cache_nbytes
    _NH_CACHE[key] = entry
    _nh_cache_nbytes += entry["nbytes"]
    while len(_NH_CACHE) > 1 and (
            len(_NH_CACHE) > _NH_CACHE_MAX
            or _nh_cache_nbytes > _NH_CACHE_MAX_BYTES):
        _, old = _NH_CACHE.popitem(last=False)
        _nh_cache_nbytes -= old["nbytes"]
    return entry


def _next_hops(spec: SystemSpec, d: Design) -> np.ndarray:
    """(N, N) int32 next-hop table (cached per (spec, design))."""
    return _design_tables(spec, d)["nh"]


# --------------------------------------------------------------------------
# Injection draws (identical RNG sequence to the reference loop)
# --------------------------------------------------------------------------

def _draw_injections(n: int, rate: np.ndarray, cycles: int, seed: int):
    """Pre-draw flit injections: (cycle, src, dst), sorted by cycle.

    Zero offered traffic is valid (idle network) — the reference
    implementation used to divide by rate.sum() and crash."""
    total_rate = float(rate.sum())
    if total_rate <= 0.0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, 0.0
    rng = np.random.default_rng(seed)
    m = rng.poisson(total_rate * cycles)
    pairs_flat = rng.choice(n * n, size=m, p=(rate / total_rate).ravel())
    inj_cycle = rng.integers(0, cycles, size=m)
    order = np.argsort(inj_cycle, kind="stable")
    pairs_flat, inj_cycle = pairs_flat[order], inj_cycle[order]
    src, dst = np.divmod(pairs_flat, n)
    return (inj_cycle.astype(np.int64), src.astype(np.int64),
            dst.astype(np.int64), total_rate)


# --------------------------------------------------------------------------
# Vectorized engine
# --------------------------------------------------------------------------

# Flit record packed into one int64: (t0 << 32) | (dst << 16) | hops.
_DST_SHIFT = 16
_T0_SHIFT = 32
_HOP_MASK = (1 << _DST_SHIFT) - 1
_DST_MASK = (1 << (_T0_SHIFT - _DST_SHIFT)) - 1


def _grow(buf: np.ndarray, head: np.ndarray, cap: int, new_cap: int):
    """Double ring-buffer capacity: unroll each ring so head == 0."""
    ne = head.size
    idx = (head[:, None] + np.arange(cap)[None, :]) & (cap - 1)
    new = np.zeros((ne, new_cap), dtype=buf.dtype)
    new[:, :cap] = np.take_along_axis(buf.reshape(ne, cap), idx, axis=1)
    head[:] = 0
    return new.reshape(-1), new_cap


# Below this many flits in a cycle, scalar Python beats the fixed overhead
# of the vectorized pass (~40 NumPy dispatches); both paths execute the
# identical algorithm on the same ring buffers.
_SCALAR_MAX = 16


def _run_sims(sims: list[dict], n: int, router_stages: int,
              cycles: int, warmup: int) -> list[dict]:
    """Advance a batch of independent simulations cycle-by-cycle.

    Each ``sims[i]`` carries its design tables and pre-drawn injections;
    all per-link FIFO state lives in flat arrays indexed by the global edge
    id ``sim * E + local_edge``, so one pass of NumPy ops per cycle moves
    every flit of every simulation. Near-idle cycles take a scalar fast
    path over the same buffers."""
    n_sims = len(sims)
    e_max = max(s["tables"]["n_edges"] for s in sims)
    ne = n_sims * e_max

    # Per-global-edge constants.
    edge_b = np.zeros(ne, dtype=np.int64)       # head-node of the edge
    edge_tab = np.zeros(ne, dtype=np.int64)     # offset into nh/eid stacks
    edge_sim = np.zeros(ne, dtype=np.int64)
    edge_base = np.zeros(ne, dtype=np.int64)    # sim * e_max
    nh_stack = np.concatenate(
        [s["tables"]["nh"].ravel().astype(np.int64) for s in sims])
    eid_stack = np.concatenate(
        [s["tables"]["edge_id"].ravel() for s in sims])
    for i, s in enumerate(sims):
        t = s["tables"]
        lo = i * e_max
        edge_b[lo:lo + t["n_edges"]] = t["edge_b"]
        edge_tab[lo:lo + e_max] = i * n * n
        edge_sim[lo:lo + e_max] = i
        edge_base[lo:lo + e_max] = lo

    # Injections: per-sim streams merged, stably sorted by cycle (per-sim
    # draw order is preserved for equal cycles; cross-sim interleaving is
    # irrelevant — edge namespaces are disjoint).
    inj_c, inj_tgt, inj_val = [], [], []
    for i, s in enumerate(sims):
        ic, src, dst = s["inj_cycle"], s["inj_src"], s["inj_dst"]
        t = s["tables"]
        nxt = t["nh"][src, dst].astype(np.int64)
        inj_c.append(ic)
        inj_tgt.append(i * e_max + t["edge_id"][src, nxt])
        inj_val.append((ic << _T0_SHIFT) | (dst << _DST_SHIFT))
    inj_c = np.concatenate(inj_c) if inj_c else np.zeros(0, np.int64)
    order = np.argsort(inj_c, kind="stable")
    inj_c = inj_c[order]
    inj_tgt = np.concatenate(inj_tgt)[order]
    inj_val = np.concatenate(inj_val)[order]
    inj_off = np.searchsorted(inj_c, np.arange(cycles + 1))

    cap = 8
    buf = np.zeros(ne * cap, dtype=np.int64)
    head = np.zeros(ne, dtype=np.int64)
    cnt = np.zeros(ne, dtype=np.int64)

    rs = np.int64(router_stages)
    rs_i = int(router_stages)
    lat_chunks: list[np.ndarray] = []
    sim_chunks: list[np.ndarray] = []
    lat_scalar: list[int] = []
    sim_scalar: list[int] = []
    in_flight = 0
    empty = np.zeros(0, dtype=np.int64)

    for t in range(cycles):
        lo, hi = int(inj_off[t]), int(inj_off[t + 1])
        if in_flight == 0 and lo == hi:
            continue

        if in_flight + (hi - lo) <= _SCALAR_MAX:
            # ---- scalar fast path (few flits: Python beats dispatch) -----
            moved = []
            for e in np.flatnonzero(cnt).tolist():
                h = int(head[e])
                moved.append((e, int(buf[e * cap + h])))
                head[e] = (h + 1) & (cap - 1)
                cnt[e] -= 1
            in_flight -= len(moved)
            for e, val in moved:
                dst = (val >> _DST_SHIFT) & _DST_MASK
                bn = int(edge_b[e])
                if bn == dst:
                    if t >= warmup:
                        lat_scalar.append((t - (val >> _T0_SHIFT)) +
                                          ((val & _HOP_MASK) + 1) * rs_i)
                        sim_scalar.append(int(edge_sim[e]))
                    continue
                tab = int(edge_tab[e])
                nxt = int(nh_stack[tab + bn * n + dst])
                tgt = int(edge_base[e]) + int(eid_stack[tab + bn * n + nxt])
                c = int(cnt[tgt])
                while c >= cap:
                    buf, cap = _grow(buf, head, cap, cap * 2)
                buf[tgt * cap + ((int(head[tgt]) + c) & (cap - 1))] = val + 1
                cnt[tgt] = c + 1
                in_flight += 1
            for j in range(lo, hi):
                tgt = int(inj_tgt[j])
                c = int(cnt[tgt])
                while c >= cap:
                    buf, cap = _grow(buf, head, cap, cap * 2)
                buf[tgt * cap + ((int(head[tgt]) + c) & (cap - 1))] = \
                    int(inj_val[j])
                cnt[tgt] = c + 1
                in_flight += 1
            continue

        # -- pop the head flit of every non-empty link queue ---------------
        if in_flight:
            act = np.flatnonzero(cnt)
            h = head[act]
            val = buf[act * cap + h]
            head[act] = (h + 1) & (cap - 1)
            cnt[act] -= 1
            in_flight -= act.size
            dst = (val >> _DST_SHIFT) & _DST_MASK
            bn = edge_b[act]
            deliv = bn == dst
            if deliv.any():
                fwd = ~deliv
                if t >= warmup:
                    lat = ((t - (val >> _T0_SHIFT)) +
                           ((val & _HOP_MASK) + 1) * rs)[deliv]
                    lat_chunks.append(lat)
                    sim_chunks.append(edge_sim[act[deliv]])
                act, val, dst, bn = act[fwd], val[fwd], dst[fwd], bn[fwd]
            # -- forwarded flits: next queue via this sim's tables ---------
            if act.size:
                tab = edge_tab[act]
                nxt = nh_stack[tab + bn * n + dst]
                tgt = edge_base[act] + eid_stack[tab + bn * n + nxt]
                fval = val + 1  # hops live in the low bits
            else:
                tgt, fval = empty, empty
        else:
            tgt, fval = empty, empty

        # -- enqueue: forwarded (source-edge order) then injections --------
        if lo != hi:
            tgt = np.concatenate([tgt, inj_tgt[lo:hi]])
            fval = np.concatenate([fval, inj_val[lo:hi]])
        if tgt.size:
            order = np.argsort(tgt, kind="stable")
            ts = tgt[order]
            ar = np.arange(ts.size)
            newgrp = np.empty(ts.size, dtype=bool)
            newgrp[0] = True
            np.not_equal(ts[1:], ts[:-1], out=newgrp[1:])
            k = ar - np.maximum.accumulate(np.where(newgrp, ar, 0))
            c0 = cnt[ts]
            need = int((c0 + k).max()) + 1
            while need > cap:
                buf, cap = _grow(buf, head, cap, cap * 2)
            buf[ts * cap + ((head[ts] + c0 + k) & (cap - 1))] = fval[order]
            # Duplicate-index assignment is applied in index order, so the
            # last write per group (largest k) sets the final queue length.
            cnt[ts] = c0 + k + 1
            in_flight += ts.size

    # ------------------------------------------------------------- stats
    eff = cycles - warmup
    if lat_scalar:
        lat_chunks.append(np.asarray(lat_scalar, np.int64))
        sim_chunks.append(np.asarray(sim_scalar, np.int64))
    lat_all = (np.concatenate(lat_chunks) if lat_chunks
               else np.zeros(0, np.int64))
    sim_all = (np.concatenate(sim_chunks) if sim_chunks
               else np.zeros(0, np.int64))
    delivered = np.bincount(sim_all, minlength=n_sims)
    lat_sum = np.bincount(sim_all, weights=lat_all, minlength=n_sims)
    order = np.argsort(sim_all, kind="stable")
    bounds = np.searchsorted(sim_all[order], np.arange(n_sims + 1))
    out = []
    for i, s in enumerate(sims):
        dcount = int(delivered[i])
        lats = lat_all[order[bounds[i]:bounds[i + 1]]]
        out.append(dict(
            throughput=dcount / eff,
            offered=s["offered"],
            mean_latency=(lat_sum[i] / dcount) if dcount else np.inf,
            p99_latency=float(np.percentile(lats, 99)) if dcount else np.inf,
            delivered=dcount,
        ))
    return out


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def simulate_batch(
    spec: SystemSpec,
    designs: list[Design],
    f: np.ndarray,
    *,
    scales=(1.0,),
    seeds=(0,),
    perm_traffic: bool = True,
    cycles: int = 3000,
    warmup: int = 500,
) -> dict:
    """Simulate the cross product ``designs x scales x seeds`` in one batch.

    ``scales`` are injection-scale multipliers applied to ``f`` (the
    ``inj_scale`` of :func:`simulate`); ``seeds`` are RNG seeds. Next-hop
    tables are built (and cached) once per design, and every simulation
    advances in the same vectorized cycle loop.

    Returns a dict of arrays, each of shape (len(designs), len(scales),
    len(seeds)): ``throughput``, ``offered``, ``mean_latency``,
    ``p99_latency``, ``delivered``.
    """
    n = spec.n_tiles
    shape = (len(designs), len(scales), len(seeds))
    keys = ("throughput", "offered", "mean_latency", "p99_latency",
            "delivered")
    if 0 in shape:
        return {k: np.zeros(shape) for k in keys}
    sims = []
    for di, d in enumerate(designs):
        tables = _design_tables(spec, d)
        fs = f[d.perm][:, d.perm] if perm_traffic else f
        fs = fs * (1.0 - np.eye(n))
        # Fail loudly on unroutable traffic (the reference loop KeyErrors);
        # silently mis-indexing the ring buffers would corrupt other sims.
        if not tables["reach"][fs > 0].all():
            raise ValueError(
                f"designs[{di}] is disconnected for its offered traffic: "
                "some (src, dst) pairs with f > 0 have no route")
        for s in scales:
            rate = fs * s
            for seed in seeds:
                ic, src, dst, total = _draw_injections(n, rate, cycles, seed)
                sims.append(dict(tables=tables, inj_cycle=ic, inj_src=src,
                                 inj_dst=dst, offered=total))
    results = _run_sims(sims, n, spec.router_stages, cycles, warmup)
    return {k: np.asarray([r[k] for r in results]).reshape(shape)
            for k in keys}


def simulate(
    spec: SystemSpec,
    d: Design,
    f: np.ndarray,
    *,
    perm_traffic: bool = True,
    inj_scale: float = 1.0,
    cycles: int = 3000,
    warmup: int = 500,
    seed: int = 0,
) -> dict:
    """Run the flit simulator; returns throughput (delivered flits/cycle),
    offered load, mean packet latency, and p99 latency.

    Thin wrapper over :func:`simulate_batch` with a single (design, scale,
    seed) — semantics (and, per seed, results) identical to
    :func:`simulate_reference`."""
    r = simulate_batch(spec, [d], f, scales=(inj_scale,), seeds=(seed,),
                       perm_traffic=perm_traffic, cycles=cycles,
                       warmup=warmup)
    out = {k: v[0, 0, 0] for k, v in r.items()}
    out["delivered"] = int(out["delivered"])
    out["throughput"] = float(out["throughput"])
    out["offered"] = float(out["offered"])
    out["mean_latency"] = float(out["mean_latency"])
    return out


def simulate_reference(
    spec: SystemSpec,
    d: Design,
    f: np.ndarray,
    *,
    perm_traffic: bool = True,
    inj_scale: float = 1.0,
    cycles: int = 3000,
    warmup: int = 500,
    seed: int = 0,
) -> dict:
    """The original per-cycle, per-edge Python loop — kept as the executable
    specification the vectorized engine is tested against. Do not use in hot
    paths."""
    n = spec.n_tiles
    nh = _next_hops(spec, d)
    fs = f[d.perm][:, d.perm] if perm_traffic else f
    fs = fs * (1.0 - np.eye(n))
    rate = fs * inj_scale
    inj_cycle, src_all, dst_all, total_rate = _draw_injections(
        n, rate, cycles, seed)
    m = inj_cycle.size

    queues: dict[tuple[int, int], deque] = {}
    full_adj = d.adj | spec.vertical_adj
    for a in range(n):
        for b in range(n):
            if full_adj[a, b]:
                queues[(a, b)] = deque()
    edges = list(queues.keys())

    delivered = 0
    lat_sum = 0.0
    lats: list[int] = []
    ptr = 0
    for t in range(cycles):
        # 1 flit per link per cycle; each traversal also pays the router
        # pipeline (spec.router_stages, tracked per-flit via hop count).
        moved = []
        for (a, b) in edges:
            q = queues[(a, b)]
            if q:
                moved.append((b, q.popleft()))
        for b, (t0, dst, hops) in moved:
            if b == dst:
                if t >= warmup:
                    lat = (t - t0) + (hops + 1) * spec.router_stages
                    delivered += 1
                    lat_sum += lat
                    lats.append(lat)
            else:
                queues[(b, nh[b, dst])].append((t0, dst, hops + 1))

        while ptr < m and inj_cycle[ptr] == t:
            s, dd = int(src_all[ptr]), int(dst_all[ptr])
            queues[(s, nh[s, dd])].append((t, dd, 0))
            ptr += 1

    eff_cycles = cycles - warmup
    return dict(
        throughput=delivered / eff_cycles,
        offered=total_rate,
        mean_latency=(lat_sum / delivered) if delivered else np.inf,
        p99_latency=float(np.percentile(lats, 99)) if lats else np.inf,
        delivered=delivered,
    )


def saturation_throughput(
    spec: SystemSpec, d: Design, f: np.ndarray, *, seed: int = 0,
    scales=(4.0, 8.0, 16.0, 32.0), cycles: int = 2000,
) -> float:
    """Accepted throughput under heavy offered load (network saturation) —
    the quantity Fig. 4 plots against Ū and σ. One batched call sweeping
    all injection scales (next-hop tables are built once)."""
    return float(saturation_throughput_batch(
        spec, [d], f, seed=seed, scales=scales, cycles=cycles)[0])


def saturation_throughput_batch(
    spec: SystemSpec, designs: list[Design], f: np.ndarray, *, seed: int = 0,
    scales=(4.0, 8.0, 16.0, 32.0), cycles: int = 2000,
) -> np.ndarray:
    """(len(designs),) saturation throughput — the whole designs x scales
    sweep runs as one :func:`simulate_batch` call."""
    inj = [s / max(f.sum(), 1e-9) for s in scales]
    r = simulate_batch(spec, designs, f, scales=inj, seeds=(seed,),
                       cycles=cycles, warmup=cycles // 4)
    return r["throughput"][:, :, 0].max(axis=1)


def simulated_edp(spec: SystemSpec, d: Design, f: np.ndarray,
                  energy: float, *, seed: int = 0, cycles: int = 3000) -> float:
    """Network EDP with SIMULATED latency (paper §6.1's metric): mean packet
    latency at the application's native injection rate x network energy.
    Routing tables are cached per (spec, design) like every other entry
    point."""
    r = simulate(spec, d, f, cycles=cycles, seed=seed)
    return r["mean_latency"] * energy
