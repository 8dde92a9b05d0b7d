"""Device-resident meta-search scoring — one device pass per greedy step.

The meta-search step works on *moves* (problem.NeighborMoves): the base
design goes to the device as a permutation plus a planar-link-mask vector,
the neighborhood as (B,) move-index arrays, and move-apply → featurize runs
as PyTorch ops on the device (a transliteration of the reference's
``repro.core.fused._fused_features``, in f32). The normalize → forest
traverse → (max, first argmax) tail is kernel K3 (``csrc/forest.cu``), so
only two scalars come back. Only the winning move is materialized, on the
host, after the accept test.

Every link-mask feature is computed incrementally from base-design scalars
built in host numpy — each is an exact small integer in f32 (integer
Manhattan lens, 0/1 mask), so host and device agree bitwise — and a
per-candidate delta: a swap touches no links, a link move exactly one
removed and one added edge. Swap rows re-flag the edges incident to the two
swapped slots.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from .features import _batch_consts
from .forest import RegressionForest
from .problem import Design, NeighborMoves, SystemSpec

META_BACKENDS = ("host", "fused")


def check_meta_backend(backend: str | None, *, allow_none: bool = False) -> None:
    if backend is None and allow_none:
        return
    if backend == "fused-pallas":
        raise ValueError(
            "meta_backend 'fused-pallas' is replaced in repro_torch by "
            "'fused' (its scoring tail is the CUDA kernel K3 on a card)")
    if backend not in META_BACKENDS:
        raise ValueError(
            f"meta_backend must be one of {META_BACKENDS}, got {backend!r}")


@lru_cache(maxsize=8)
def _host_consts(spec: SystemSpec):
    """Spec-static numpy arrays for the fused featurizer, plus the (N, N) →
    triu edge-index map used to encode link moves."""
    c = _batch_consts(spec)
    n = spec.n_tiles
    e = c["iu0"].shape[0]
    eid = np.full((n, n), -1, np.int32)
    eid[c["iu0"], c["iu1"]] = np.arange(e, dtype=np.int32)
    eid[c["iu1"], c["iu0"]] = np.arange(e, dtype=np.int32)
    # Per-slot incident-edge table: inc_edges[x] lists the n-1 triu edge
    # ids touching slot x, other_slot[x] the opposite endpoint of each.
    inc_edges = np.empty((n, n - 1), np.int64)
    other_slot = np.empty((n, n - 1), np.int64)
    for x in range(n):
        ids = np.flatnonzero((c["iu0"] == x) | (c["iu1"] == x))
        inc_edges[x] = ids
        other_slot[x] = np.where(c["iu0"][ids] == x,
                                 c["iu1"][ids], c["iu0"][ids])
    lens = np.asarray(c["lens"], np.float32)
    loh = np.asarray(c["layer_onehot"], np.float32)
    f32 = np.float32
    # _ext arrays carry a scratch tail entry (edge E -> zero weight, node
    # n) so identity rows produce exact-zero deltas.
    arrays = {
        "layer": c["layer"].astype(f32),
        "col_onehot": c["col_onehot"].astype(f32),
        "lens_ext": np.append(lens, 0.0).astype(f32),
        "loh_ext": np.vstack([loh, np.zeros((1, loh.shape[1]), f32)]),
        "man2": c["man2"].astype(f32),
        "vert_deg": c["vert_deg"].astype(f32),
        "iu0_ext": np.append(c["iu0"], n).astype(np.int64),
        "iu1_ext": np.append(c["iu1"], n).astype(np.int64),
        "inc_edges": inc_edges,
        "other_slot": other_slot,
        "eid_safe": np.maximum(eid, 0).astype(np.int64),
        "is_cpu": c["is_cpu"].astype(f32),
        "is_llc": c["is_llc"].astype(f32),
        "is_gpu": c["is_gpu"].astype(f32),
        "power": spec.core_power.astype(f32),
    }
    host = {"lens": lens, "lens2": (lens * lens).astype(f32), "loh": loh,
            "is_llc": c["is_llc"].astype(f32), "iu0": np.asarray(c["iu0"]),
            "iu1": np.asarray(c["iu1"]), "n": n, "k": loh.shape[1]}
    return arrays, host, eid, e


@lru_cache(maxsize=8)
def _device_consts(spec: SystemSpec, device: str) -> dict:
    arrays = _host_consts(spec)[0]
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def fused_features(c: dict, k: int, base_perm, base_lm, base_scalars,
                   sa, sb, er, ea) -> torch.Tensor:
    """(B, F) f32 features of base+move candidates.

    ``sa``/``sb`` are swap slot pairs (identity when equal); ``er``/``ea``
    are removed/added edge indices in triu order, with the scratch sentinel
    ``E`` for non-link rows. The formulas follow
    features.design_features_batch (FEATURE_NAMES order)."""
    counts0, sums0, llc_slot0, ends0_ext, deg0 = base_scalars
    s1_0, s2_0, lm_cnt, s_llc0 = sums0[0], sums0[1], sums0[2], sums0[3]
    bsz = sa.shape[0]
    n = base_perm.shape[0]
    rows = torch.arange(bsz, device=sa.device)
    layer = c["layer"]
    kf = float(k)

    # ---------------------------------------------- perm-side (O(B*N))
    perms = base_perm.expand(bsz, n).clone()
    pa, pb = base_perm[sa], base_perm[sb]
    perms[rows, sa] = pb
    perms[rows, sb] = pa

    is_cpu = c["is_cpu"][perms]
    is_llc = c["is_llc"][perms]
    is_gpu = c["is_gpu"][perms]
    power = c["power"][perms]

    def mstats_masked(x_row, mask):
        cnt = mask.sum(1)
        m1 = (mask * x_row).sum(1) / cnt
        m2 = (mask * x_row * x_row).sum(1) / cnt
        return m1, torch.sqrt(torch.clamp(m2 - m1 * m1, min=0.0))

    llc_mean, llc_std = mstats_masked(layer, is_llc)
    cpu_mean = (layer * is_cpu).sum(1) / is_cpu.sum(1)
    gpu_mean = (layer * is_gpu).sum(1) / is_gpu.sum(1)
    power_depth = (power * layer).sum(1) / (power.sum(1) * kf)
    col_power = power @ c["col_onehot"]
    col_power_std = (col_power.std(1, correction=0)
                     / (col_power.mean(1) + 1e-9))

    # ------------------------------------------- link-move deltas (O(B*K))
    counts = counts0[None, :] - c["loh_ext"][er] + c["loh_ext"][ea]
    p = counts / counts.sum(1, keepdim=True)
    entropy = -(p * torch.log(p + 1e-12)).sum(1) / float(np.log(kf))
    s1 = s1_0 - c["lens_ext"][er] + c["lens_ext"][ea]
    s2 = s2_0 - c["lens_ext"][er] ** 2 + c["lens_ext"][ea] ** 2
    len_mean = s1 / lm_cnt
    len_std = torch.sqrt(torch.clamp(s2 / lm_cnt - len_mean * len_mean,
                                     min=0.0))

    # deg: one (B, 4) scatter onto a scratch-node column (both endpoints of
    # the removed edge -1, of the added edge +1); small integers, exact.
    didx = torch.stack([c["iu0_ext"][er], c["iu1_ext"][er],
                        c["iu0_ext"][ea], c["iu1_ext"][ea]], dim=1)
    # [-1, -1, 1, 1] made on the device: a list copied from the host would
    # be a blocking copy on every call.
    dupd = (torch.arange(4, device=deg0.device) // 2 * 2 - 1).to(
        deg0.dtype).expand(bsz, 4)
    deg = (deg0.expand(bsz, n + 1).clone().scatter_add_(1, didx, dupd)
           [:, :n] + c["vert_deg"])
    llc_deg_mean = (deg * is_llc).sum(1) / is_llc.sum(1)

    # LLC link fraction: link rows move one edge's base end-flag out/in;
    # swap rows re-flag the <= 2(N-1) edges incident to the swapped slots.
    # The (sa, sb) edge appears in both incident walks with a spurious
    # -|la - lb| total (its true delta is zero), which the last term
    # cancels; identity rows zero out termwise.
    la, lb = llc_slot0[sa], llc_slot0[sb]

    def swap_end_delta(x, v_old, v_new):
        eids = c["inc_edges"][x]                               # (B, N-1)
        lo = llc_slot0[c["other_slot"][x]]
        w = base_lm[eids]
        return ((torch.maximum(v_new[:, None], lo)
                 - torch.maximum(v_old[:, None], lo)) * w).sum(1)

    s_llc = (s_llc0
             - ends0_ext[er] + ends0_ext[ea]
             + swap_end_delta(sa, la, lb) + swap_end_delta(sb, lb, la)
             + torch.abs(la - lb) * base_lm[c["eid_safe"][sa, sb]])
    llc_link_frac = s_llc / torch.clamp(lm_cnt, min=1.0)

    n_llc = is_llc.sum(1)
    cpu_llc = ((is_cpu @ c["man2"]) * is_llc).sum(1) / (is_cpu.sum(1) * n_llc)
    gpu_llc = ((is_gpu @ c["man2"]) * is_llc).sum(1) / (is_gpu.sum(1) * n_llc)

    return torch.stack([
        llc_mean / kf, llc_std / kf, cpu_mean / kf, gpu_mean / kf,
        power_depth, col_power_std,
        entropy, len_mean, len_std,
        deg.mean(1), deg.std(1, correction=0), deg.amax(1),
        llc_deg_mean, cpu_llc, gpu_llc, llc_link_frac,
    ], dim=1).contiguous()


class MetaScorer:
    """Per-(spec, fitted forest) scorer for the fused meta-greedy step on
    one device (default ``"cuda"``): torch featurization, then kernel K3
    (its plain version on the CPU)."""

    def __init__(self, spec: SystemSpec, model: RegressionForest, *,
                 backend: str = "fused",
                 device: str | torch.device | None = None):
        check_meta_backend(backend)
        if backend == "host":
            raise ValueError("MetaScorer is the device path; use "
                             "stage._meta_greedy_host for backend='host'")
        self.device = resolve_device(device)
        self.spec = spec
        _, self._h, self._eid, self._e = _host_consts(spec)
        self.c = _device_consts(spec, str(self.device))
        self._iu0, self._iu1 = self._h["iu0"], self._h["iu1"]
        self.forest = model.packed(self.device)
        self.xm = torch.as_tensor(model._xm.astype(np.float32),
                                  device=self.device)
        self.xs = torch.as_tensor(model._xs.astype(np.float32),
                                  device=self.device)
        # K3's (value bits, row) on the device, read back in one 8-byte copy.
        self._out = torch.empty(2, dtype=torch.int32, device=self.device)
        self._out_host = torch.empty(
            2, dtype=torch.int32, pin_memory=self.device.type == "cuda")

    # ------------------------------------------------------------- encoding
    def _encode(self, moves: NeighborMoves) -> tuple:
        """The neighborhood as move-index arrays: swap rows carry their slot
        pair and the scratch edge, link rows an identity swap and their
        edge ids."""
        s = moves.swaps.shape[0]
        b = len(moves)
        sa = np.zeros(b, np.int64)
        sb = np.zeros(b, np.int64)
        er = np.full(b, self._e, np.int64)
        ea = np.full(b, self._e, np.int64)
        sa[:s] = moves.swaps[:, 0]
        sb[:s] = moves.swaps[:, 1]
        er[s:b] = self._eid[moves.rem[:, 0], moves.rem[:, 1]]
        ea[s:b] = self._eid[moves.add[:, 0], moves.add[:, 1]]
        return sa, sb, er, ea

    def _base_state(self, d: Design) -> tuple:
        """(base_perm, base_lm, base_scalars) in host numpy — the base
        design's link scalars are exact small integers in f32."""
        h = self._h
        n = h["n"]
        lm = d.adj[self._iu0, self._iu1].astype(np.float32)
        counts0 = lm @ h["loh"]                                  # (K,)
        llc_slot0 = h["is_llc"][d.perm]                          # (N,)
        ends0 = np.maximum(llc_slot0[self._iu0], llc_slot0[self._iu1])
        sums0 = np.array([h["lens"] @ lm, h["lens2"] @ lm,
                          lm.sum(), ends0 @ lm], np.float32)
        ends0_ext = np.append(ends0, np.float32(0.0))
        deg0 = (np.bincount(self._iu0, weights=lm, minlength=n + 1)
                + np.bincount(self._iu1, weights=lm, minlength=n + 1)
                ).astype(np.float32)
        scalars = (counts0, sums0, llc_slot0, ends0_ext, deg0)
        return d.perm.astype(np.int64), lm, scalars

    def _score(self, d: Design, sa, sb, er, ea) -> tuple[int, float]:
        base_perm, base_lm, scalars = self._base_state(d)

        def t(a):
            return torch.as_tensor(a, device=self.device)

        feats = fused_features(
            self.c, self._h["k"], t(base_perm), t(base_lm),
            tuple(t(s) for s in scalars), t(sa), t(sb), t(er), t(ea))
        ops.score_block_max_packed(self.forest, self.xm, self.xs, feats,
                                   feats.shape[0], self._out)
        out = self._out_host.copy_(self._out).numpy()
        return int(out[1]), float(out[:1].view(np.float32)[0])

    # -------------------------------------------------------------- scoring
    def score_base(self, d: Design) -> float:
        """Eval(d) — the fused twin of predict(features([d]))[0]."""
        one = np.zeros(1, np.int64)
        edge = np.full(1, self._e, np.int64)
        return self._score(d, one, one, edge, edge)[1]

    def score_moves(self, moves: NeighborMoves) -> tuple[int, float]:
        """(argmax j, Eval of candidate j) over the neighborhood.
        Tie-break matches np.argmax (first max)."""
        return self._score(moves.base, *self._encode(moves))
