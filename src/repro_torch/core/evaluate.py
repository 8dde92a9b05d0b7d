"""Batched design evaluation — the optimizer's compute hot loop.

Every candidate batch runs cost build → batched APSP (kernel K1) → next-hop
argmin → path walk (kernel K4) → Eqs. 1-10 on one device. The device is
explicit: ``Evaluator(spec, f, device=...)`` defaults to ``"cuda"`` and
raises when no card is present; ``device="cpu"`` runs the kernels' plain
versions.

PyTorch runs eagerly, so batches are not padded to a power of two; the
chunking by ``max_batch`` is the reference's, so ``n_evals`` and ``n_calls``
count the same over the same calls.

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
from . import routing
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


class Evaluator:
    """Batched evaluator for a fixed (spec, traffic) pair on one device."""

    def __init__(self, spec: SystemSpec, f: np.ndarray, *,
                 backend: str = "auto", device: str | torch.device | None = None,
                 max_batch: int | None = 256, delta: str = "auto",
                 table_cache_bytes: int = 256 << 20,
                 split_devices=None):
        if delta not in DELTA_MODES:
            raise ValueError(f"delta must be one of {DELTA_MODES}, got {delta!r}")
        self.spec = spec
        self.backend = routing.resolve_backend(backend)
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
        # (device, consts, traffic) per chunk of a split batch.
        self._parts = [
            (d, self.consts, self.f) if d == self.device else
            (d, make_consts(spec, str(d)),
             torch.as_tensor(np.asarray(f, dtype=np.float32), device=d))
            for d in self.split_devices or ()]
        # Incremental move evaluation (batch_moves): swap candidates reuse
        # the base design's tables verbatim (adjacency is slot-keyed, a swap
        # only permutes cores); link moves get an O(N²) table delta
        # (routing.delta_link_move) instead of a full APSP. Off for a split
        # evaluator, whose chunks recompute their tables on their devices.
        self.delta_mode = delta
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

    def _to_dev(self, arrays, dtype, device=None) -> torch.Tensor:
        return torch.as_tensor(np.stack(arrays), dtype=dtype,
                               device=self.device if device is None
                               else device)

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
        if self.max_batch is not None and len(designs) > self.max_batch:
            outs, auxes = zip(*(
                self.batch_aux(designs[i:i + self.max_batch])
                for i in range(0, len(designs), self.max_batch)))
            return (np.concatenate(outs, axis=0),
                    {k: np.concatenate([a[k] for a in auxes], axis=0)
                     for k in auxes[0]})
        if self.split_devices is None:
            outs = [self._dense(self.device, self.consts, self.f, designs)]
        else:
            # Contiguous chunks, the first len % ndev one design longer;
            # every chunk is launched before any result is read back, so
            # the devices run at once.
            base, rem = divmod(len(designs), len(self._parts))
            outs, lo = [], 0
            for i, (dev, consts, f) in enumerate(self._parts):
                hi = lo + base + (1 if i < rem else 0)
                if hi > lo:
                    outs.append(self._dense(dev, consts, f, designs[lo:hi]))
                lo = hi
        self.n_evals += len(designs)
        self.n_calls += 1
        with span("noc.eval.read"):
            objs = np.concatenate([o.cpu().numpy() for o, _ in outs], axis=0)
            aux = {k: np.concatenate([a[k].cpu().numpy() for _, a in outs],
                                     axis=0) for k in outs[0][1]}
            return objs.astype(np.float64), aux

    def _dense(self, device, consts, f, designs):
        """Cost build → APSP (K1) → next hops → walk (K4) → objectives for
        ``designs`` on ``device``; returns the device tensors."""
        with span("noc.eval.pack"):
            perms = self._to_dev([d.perm for d in designs], torch.int64,
                                 device)
            adjs = self._to_dev([d.adj for d in designs], torch.bool, device)
        with span("noc.eval.enqueue"):
            costs = design_cost(consts, adjs)
            dist, nh = routing.routing_tables_batched(costs,
                                                      consts.apsp_iters)
            return evaluate_with_tables(consts, perms, adjs, f, dist, nh)

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
        if not self.delta_on:
            with span("noc.eval.pack"):
                designs = [d for m in mvs for d in m.materialize_all()]
            return self.batch(designs)
        perms, adjs, dists, nhs = [], [], [], []
        with span("noc.eval.delta"):
            for mv in mvs:
                t0 = self._host_tables(mv.base)
                for s in range(mv.swaps.shape[0]):
                    a, b = int(mv.swaps[s, 0]), int(mv.swaps[s, 1])
                    p = mv.base.perm.copy()
                    p[a], p[b] = p[b], p[a]
                    perms.append(p)
                    adjs.append(mv.base.adj)
                    dists.append(t0.dist)
                    nhs.append(t0.nh)
                self.delta_stats["swap"] += mv.swaps.shape[0]
                count("noc.delta.swap", mv.swaps.shape[0])
                for k in range(mv.rem.shape[0]):
                    rem = (int(mv.rem[k, 0]), int(mv.rem[k, 1]))
                    add = (int(mv.add[k, 0]), int(mv.add[k, 1]))
                    t = self._moved_tables(t0, rem, add)
                    adj2 = mv.base.adj.copy()
                    adj2[rem[0], rem[1]] = adj2[rem[1], rem[0]] = False
                    adj2[add[0], add[1]] = adj2[add[1], add[0]] = True
                    perms.append(mv.base.perm)
                    adjs.append(adj2)
                    dists.append(t.dist)
                    nhs.append(t.nh)
            count("noc.delta.served", len(perms))
        return self._eval_from_tables(perms, adjs, dists, nhs)

    def note_accept(self, mv: NeighborMoves, j: int) -> None:
        """Tell the evaluator candidate ``j`` of ``mv`` was accepted: cache
        the winner's host tables (one delta from the already-cached base) so
        the next step's neighborhood starts from a cache hit. No-op when
        deltas are off or the winner is a swap (same adjacency)."""
        if not self.delta_on:
            return
        s = mv.swaps.shape[0]
        if j < s:
            return
        k = j - s
        rem = (int(mv.rem[k, 0]), int(mv.rem[k, 1]))
        add = (int(mv.add[k, 0]), int(mv.add[k, 1]))
        adj2 = mv.base.adj.copy()
        adj2[rem[0], rem[1]] = adj2[rem[1], rem[0]] = False
        adj2[add[0], add[1]] = adj2[add[1], add[0]] = True
        key = np.packbits(adj2).tobytes()
        with span("noc.eval.delta"):
            if key in self._tab_cache:
                self._tab_cache.move_to_end(key)
                return
            t = self._moved_tables(self._host_tables(mv.base), rem, add)
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
            cost2 = t0.cost.copy()
            cost2[rem[0], rem[1]] = cost2[rem[1], rem[0]] = np.float32(routing.INF)
            cost2[add[0], add[1]] = cost2[add[1], add[0]] = w
            with span("noc.eval.rebuild"):
                return routing.host_tables(cost2, self.consts.apsp_iters)
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

    def _eval_from_tables(self, perms, adjs, dists, nhs) -> np.ndarray:
        """Run the objective walk over candidates with precomputed routing
        tables, chunked by ``max_batch``; the same eval/call counters
        apply."""
        out = []
        step = self.max_batch if self.max_batch is not None else len(perms)
        for i in range(0, len(perms), step):
            sl = slice(i, i + step)
            with span("noc.eval.pack"):
                adj = self._to_dev(adjs[sl], torch.bool)
                perm = self._to_dev(perms[sl], torch.int64)
                dist = self._to_dev(dists[sl], torch.float32)
                nh = self._to_dev(nhs[sl], torch.int32)
            with span("noc.eval.enqueue"):
                objs, _ = evaluate_with_tables(self.consts, perm, adj,
                                               self.f, dist, nh)
            self.n_evals += adj.shape[0]
            self.n_calls += 1
            with span("noc.eval.read"):
                out.append(objs.cpu().numpy().astype(np.float64))
        return np.concatenate(out, axis=0)

    # ---------------------------------------------------------------- EDP
    def edp(self, d: Design) -> float:
        """Network EDP = network latency x network energy (paper §6.1; the
        analytic variant)."""
        objs, aux = self.batch_aux([d])
        return float(aux["net_lat"][0] * objs[0, 3])
