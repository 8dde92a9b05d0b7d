"""Batched design evaluation — the optimizer's compute hot loop.

Every candidate batch runs cost build → batched APSP (kernel K1) → next-hop
argmin → path walk (kernel K4) → Eqs. 1-10 on one device. The device is
explicit: ``Evaluator(spec, f, device=...)`` defaults to ``"cuda"`` and
raises when no card is present; ``device="cpu"`` runs the kernels' plain
versions.

PyTorch runs eagerly, so batches are not padded to a power of two; the
chunking by ``max_batch`` is the reference's, so ``n_evals`` and ``n_calls``
count the same over the same calls.

On one CUDA device (no ``split_devices``) each chunk's device pass is a
replayed CUDA graph, one per chunk shape, fed and read through pinned
staging (:mod:`repro_torch.core.graphs`): the same kernels and sums as
the eager pass, so the same rows. The CPU keeps the eager pass in the
reference's host order.

``split_devices`` is the data-parallel form the distributed ``spmd``
executor uses (the reference's multi-device ``shard_map`` evaluator): each
batch is cut into contiguous chunks, one per device in the list, each
chunk evaluated on its device, and the rows concatenated in order. Each
design's rows do not depend on the other designs of its batch, so the
rows are the unsplit evaluator's; one batch still counts as one call. On
one card the split has one chunk.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..device import resolve_device
from . import graphs, routing
from .objectives import (N_OBJ, SpecConsts, design_cost, design_cost_np,
                         evaluate_with_tables, make_consts)
from .problem import Design, NeighborMoves, SystemSpec
from ..tracing import count, span

DELTA_MODES = ("auto", "on", "off")

#: ``delta="auto"`` switches move evaluation to incremental host tables at
#: this tile count. Below it (all paper specs: 8-64 tiles) the dense batch
#: stays the only path.
DELTA_AUTO_MIN_TILES = 128

#: Transient budget for one batched-APSP dispatch — bounds the (B, N, N, N)
#: next-hop broadcast by shrinking the chunk size as N grows.
_BATCH_BUDGET_BYTES = 512 << 20


def device_pass(c: SpecConsts, f: torch.Tensor, v: dict,
                out: torch.Tensor) -> None:
    """One chunk's pass on its device, from the typed fields ``v`` of its
    input (:func:`graphs.layout`): the cost build, APSP (K1) and next hops
    unless ``v`` holds tables, the walk (K4) and the objectives, written
    into ``out`` (rows, 7) as the objectives, connected, net_lat. It makes
    no host sync, so a CUDA graph can capture it."""
    tab = (v["dist"], v["nh"]) if "dist" in v else \
        routing.routing_tables_batched(design_cost(c, v["adj"]),
                                       c.apsp_iters)
    objs, aux = evaluate_with_tables(c, v["perm"], v["adj"], f, *tab)
    torch.cat([objs, aux["connected"][:, None].float(),
               aux["net_lat"][:, None]], dim=1, out=out)


class Evaluator:
    """Batched evaluator for a fixed (spec, traffic) pair on one device."""

    def __init__(self, spec: SystemSpec, f: np.ndarray, *,
                 backend: str = "auto", device: str | torch.device | None = None,
                 max_batch: int | None = 256, delta: str = "auto",
                 table_cache_bytes: int = 256 << 20,
                 split_devices=None):
        if delta not in DELTA_MODES:
            raise ValueError(f"delta must be one of {DELTA_MODES}, got {delta!r}")
        routing.resolve_backend(backend)
        self.spec = spec
        self.device = resolve_device(device)
        self.split_devices = (tuple(resolve_device(d) for d in split_devices)
                              if split_devices else None)
        n = spec.n_tiles
        if max_batch is not None:
            # Chunk bound for the batched transient: at 64 tiles a
            # 256-design chunk broadcasts 256 MiB; at 256+ tiles the same
            # chunk would be gigabytes, so the bound shrinks with N.
            per = 4 * n * n * (n if n <= routing.DENSE_NMAX
                               else routing._pow2_block(n))
            max_batch = max(1, min(max_batch, _BATCH_BUDGET_BYTES // per))
        self.max_batch = max_batch
        self.consts: SpecConsts = make_consts(spec, str(self.device))
        self.f = torch.as_tensor(np.asarray(f, dtype=np.float32),
                                 device=self.device)
        # (device, consts, traffic) per part of a chunk: one unless split.
        self._parts = [
            (d, self.consts, self.f) if d == self.device else
            (d, make_consts(spec, str(d)),
             torch.as_tensor(np.asarray(f, dtype=np.float32), device=d))
            for d in self.split_devices or (self.device,)]
        # Incremental move evaluation (batch_moves): swap candidates reuse
        # the base design's tables verbatim (adjacency is slot-keyed, a swap
        # only permutes cores); link moves get an O(N²) table delta
        # (routing.delta_link_move) instead of a full APSP. Off for a split
        # evaluator, whose chunks recompute their tables on their devices.
        self._graphs = self.split_devices is None and graphs.serves(
            self.device)
        self.delta_on = (self.split_devices is None
                         and (delta == "on"
                              or (delta == "auto"
                                  and n >= DELTA_AUTO_MIN_TILES)))
        self._tab_cache: OrderedDict[bytes, routing.HostTables] = OrderedDict()
        self._tab_cache_nbytes = 0
        self._tab_cache_max_bytes = int(table_cache_bytes)
        self.delta_stats = {"swap": 0, "delta": 0, "fallback": 0,
                            "table_hits": 0, "table_misses": 0}
        self.n_evals = 0  # evaluation counter (search-cost accounting)
        self.n_calls = 0  # device passes (batching-efficiency accounting)

    # ------------------------------------------------------------- single
    def __call__(self, d: Design) -> np.ndarray:
        return self.batch([d])[0]

    # -------------------------------------------------------------- batch
    def batch(self, designs: list[Design]) -> np.ndarray:
        """(B, 5) objective rows; invalid designs come back as +INF rows."""
        return self.batch_aux(designs)[0]

    def batch_aux(self, designs: list[Design]) -> tuple[np.ndarray, dict]:
        if not designs:
            return np.zeros((0, N_OBJ)), {"net_lat": np.zeros((0,))}
        return self._run(*self._host((d.perm[None], d.adj[None])
                                     for d in designs), aux=True)

    @staticmethod
    def _host(blocks) -> tuple[np.ndarray, np.ndarray]:
        """One call's host arrays: the ``(perms, adjs)`` blocks, in order,
        concatenated into (B, N) placements and (B, N, N) adjacencies; one
        block is taken as it is."""
        with span("noc.eval.pack"):
            blocks = list(blocks)
            if len(blocks) == 1:
                return blocks[0]
            perms, adjs = zip(*blocks)
            return np.concatenate(perms), np.concatenate(adjs)

    def _run(self, perms: np.ndarray, adjs: np.ndarray, tables=None, *,
             aux: bool = False):
        """Objective rows (and with ``aux`` the auxiliary outputs) of the
        candidates ``perms`` (B, N), ``adjs`` (B, N, N): per chunk of
        ``max_batch`` rows, copy to the device, enqueue cost build → APSP
        (K1) → next hops → walk (K4) → objectives, count one call, read the
        rows back. ``tables``, two lists of B host arrays (dist, next hop),
        replaces the cost build, APSP and next hops.

        On one card a chunk is :meth:`_card_chunk`'s, a replayed graph.
        Otherwise, a split evaluator cuts each chunk into contiguous parts,
        one per device, the first ``rows % ndev`` one row longer, and
        launches them all before reading any back, so the devices run at
        once."""
        n = perms.shape[0]
        step = self.max_batch or n
        chunk = self._card_chunk if self._graphs else self._parts_chunk
        objs, auxes = [], []
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            o, a = chunk(perms[lo:hi], adjs[lo:hi],
                         None if tables is None else
                         [t[lo:hi] for t in tables], aux)
            objs.append(o)
            auxes.append(a)
        objs = np.concatenate(objs, axis=0)
        if not aux:
            return objs
        return objs, {k: np.concatenate([a[k] for a in auxes], axis=0)
                      for k in auxes[0]}

    def _count(self, rows: int) -> None:
        self.n_evals += rows
        self.n_calls += 1

    def _parts_chunk(self, perms, adjs, tables, aux: bool):
        """One chunk on the CPU or across ``split_devices``: each part's
        arrays to its device, every part's pass enqueued, then read."""
        size, extra = divmod(perms.shape[0], len(self._parts))
        ends = np.cumsum([0] + [size + (i < extra)
                                for i in range(len(self._parts))])
        with span("noc.eval.pack"):
            parts = [(consts, f,
                      torch.as_tensor(perms[a:b], dtype=torch.int64,
                                      device=dev),
                      torch.as_tensor(adjs[a:b], dtype=torch.bool,
                                      device=dev),
                      None if tables is None else
                      [torch.as_tensor(np.stack(t[a:b]), dtype=dt,
                                       device=dev)
                       for t, dt in zip(tables,
                                        (torch.float32, torch.int32))])
                     for (dev, consts, f), a, b
                     in zip(self._parts, ends, ends[1:]) if b > a]
        with span("noc.eval.enqueue"):
            outs = []
            for consts, f, perm, adj, tab in parts:
                if tab is None:
                    tab = routing.routing_tables_batched(
                        design_cost(consts, adj), consts.apsp_iters)
                outs.append(evaluate_with_tables(consts, perm, adj, f, *tab))
        self._count(perms.shape[0])
        with span("noc.eval.read"):
            objs = np.concatenate([o.cpu().numpy() for o, _ in outs],
                                  axis=0).astype(np.float64)
            return objs, {k: np.concatenate(
                [a[k].cpu().numpy() for _, a in outs], axis=0)
                for k in outs[0][1]} if aux else None

    def _card_chunk(self, perms, adjs, tables, aux: bool):
        """One chunk on the single card: its host arrays into pinned
        staging, one copy into the pass's input, the pass replayed from
        its captured graph (eager on its shape's first sighting, captured
        on its second), one copy of its (rows, 7) output back, one sync.
        Counted: ``noc.eval.graph.replay`` a chunk a replay served,
        ``noc.eval.graph.eager`` one run eagerly or captured,
        ``noc.eval.graph.capture`` one captured."""
        rows, n = perms.shape
        dev = self.device
        cache = graphs.cache()
        key = (id(self.consts), dev, rows, tables is not None)
        with span("noc.eval.pack"):
            lay = graphs.layout(rows, n, tables is not None)
            host = graphs.staging("in", lay.nbytes, dev)
            v = lay.views(host)
            v["perm"].numpy()[...] = perms
            v["adj"].numpy()[...] = adjs
            if tables is not None:
                for name, t in zip(("dist", "nh"), tables):
                    np.stack(t, out=v[name].numpy())
            p, capture = cache.find(key)
            fresh = p is None
            if fresh:
                p = graphs.Pass.new(lay, self.consts, self.f, dev,
                                    static=capture)
            else:
                p.use_f(self.f)
            p.inputs.copy_(host, non_blocking=True)
        with span("noc.eval.enqueue"):
            if fresh and capture:
                cache.add(key, graphs.captured(p, lambda: device_pass(
                    p.consts, p.f, p.views, p.out), dev))
                count("noc.eval.graph.capture")
            if fresh and not capture:
                device_pass(p.consts, p.f, p.views, p.out)
            else:
                graphs.replay(p)
            count("noc.eval.graph.eager" if fresh else
                  "noc.eval.graph.replay")
        self._count(rows)
        with span("noc.eval.read"):
            out = graphs.staging("out", p.out.numel() * 4, dev).view(
                torch.float32).view(p.out.shape)
            out.copy_(p.out, non_blocking=True)
            graphs.wait(dev)
            out = out.numpy()
            objs = out[:, :N_OBJ].astype(np.float64)
            return objs, {"connected": out[:, N_OBJ] != 0,
                          "net_lat": out[:, N_OBJ + 1].copy()} if aux else None

    # -------------------------------------------------------------- moves
    def batch_moves(self, moves) -> np.ndarray:
        """(B, 5) objective rows for one or more :class:`NeighborMoves`
        neighborhoods (rows concatenate in neighborhood order, candidates in
        ``materialize`` order: swaps, then link moves).

        With deltas off this is exactly ``batch(materialize_all())``. With
        deltas on, routing tables come from the host cache: swaps reuse the
        base tables unchanged, link moves pay one O(N²) incremental update
        (full host recompute as fallback), and only the objective walk runs
        on the device. Both paths are bit-equal — see routing's host-mirror
        exactness note. Traced (:mod:`repro_torch.tracing`), the host table
        work is the span ``noc.eval.delta``, each full recompute the span
        ``noc.eval.rebuild`` inside it; the counters ``noc.delta.swap``,
        ``.link`` (fallbacks included), ``.fallback``, ``.table_hit`` and
        ``.table_miss`` follow ``delta_stats``, and ``noc.delta.served``
        counts the candidates this method serves."""
        mvs = [moves] if isinstance(moves, NeighborMoves) else list(moves)
        mvs = [m for m in mvs if len(m)]
        if not mvs:
            return np.zeros((0, N_OBJ))
        perms, adjs = self._host(m.arrays() for m in mvs)
        if not self.delta_on:
            return self._run(perms, adjs)
        dists, nhs = [], []
        with span("noc.eval.delta"):
            for mv in mvs:
                t0 = self._host_tables(mv.base)
                s = mv.swaps.shape[0]
                dists += [t0.dist] * s
                nhs += [t0.nh] * s
                self.delta_stats["swap"] += s
                count("noc.delta.swap", s)
                for rem, add in zip(mv.rem.tolist(), mv.add.tolist()):
                    t = self._moved_tables(t0, rem, add)
                    dists.append(t.dist)
                    nhs.append(t.nh)
            count("noc.delta.served", len(dists))
        return self._run(perms, adjs, (dists, nhs))

    def note_accept(self, mv: NeighborMoves, j: int) -> None:
        """Tell the evaluator candidate ``j`` of ``mv`` was accepted: cache
        the winner's host tables (one delta from the already-cached base) so
        the next step's neighborhood starts from a cache hit. No-op when
        deltas are off or the winner is a swap (same adjacency)."""
        if not self.delta_on:
            return
        k = j - mv.swaps.shape[0]
        if k < 0:
            return
        key = np.packbits(mv.materialize(j).adj).tobytes()
        with span("noc.eval.delta"):
            if key in self._tab_cache:
                self._tab_cache.move_to_end(key)
                return
            t = self._moved_tables(self._host_tables(mv.base),
                                   mv.rem[k].tolist(), mv.add[k].tolist())
            self._tab_put(key, t)

    def _host_tables(self, base: Design) -> routing.HostTables:
        key = np.packbits(base.adj).tobytes()
        t = self._tab_cache.get(key)
        if t is not None:
            self._tab_cache.move_to_end(key)
            self.delta_stats["table_hits"] += 1
            count("noc.delta.table_hit")
            return t
        self.delta_stats["table_misses"] += 1
        count("noc.delta.table_miss")
        with span("noc.eval.rebuild"):
            t = routing.host_tables(design_cost_np(self.spec, base.adj),
                                    self.consts.apsp_iters)
        self._tab_put(key, t)
        return t

    def _moved_tables(self, t0: routing.HostTables, rem, add
                      ) -> routing.HostTables:
        w = (np.float32(self.spec.router_stages)
             + np.float32(self.spec.link_delay[add[0], add[1]]))
        t = routing.delta_link_move(t0, rem, add, w)
        count("noc.delta.link")
        if t is None:
            self.delta_stats["fallback"] += 1
            count("noc.delta.fallback")
            with span("noc.eval.rebuild"):
                return routing.host_tables(
                    routing.moved_cost(t0.cost, rem, add, w),
                    self.consts.apsp_iters)
        self.delta_stats["delta"] += 1
        return t

    def _tab_put(self, key: bytes, t: routing.HostTables) -> None:
        old = self._tab_cache.pop(key, None)
        if old is not None:
            self._tab_cache_nbytes -= old.nbytes
        self._tab_cache[key] = t
        self._tab_cache_nbytes += t.nbytes
        while (self._tab_cache_nbytes > self._tab_cache_max_bytes
               and len(self._tab_cache) > 1):
            _, evicted = self._tab_cache.popitem(last=False)
            self._tab_cache_nbytes -= evicted.nbytes

    # ---------------------------------------------------------------- EDP
    def edp(self, d: Design) -> float:
        """Network EDP = network latency x network energy (paper §6.1; the
        analytic variant)."""
        objs, aux = self.batch_aux([d])
        return float(aux["net_lat"][0] * objs[0, 3])
