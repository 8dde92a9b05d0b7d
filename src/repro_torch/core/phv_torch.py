"""Device twin of the batched hypervolume scorer (core.pareto).

The PHV-greedy chain step (local_search) scores a whole candidate batch
with ``PhvContext.phv_with_batch`` — host-side recursive HSO per surviving
candidate. This module computes the same scores as one fixed-shape program
of PyTorch tensor operations on a device: the Pareto set rides in padded to
a fixed row count with a validity mask, and the HSO recursion becomes a
*masked* recursion on the (static) objective count — masked rows are
pinned at the reference point, where they dominate nothing and contribute
zero volume, so no data-dependent filtering or compaction is needed.

Shapes: the set rows pad to ``max_set`` and the candidate batch to a power
of two before the recursion, so one neighbourhood size gives one set of
shapes. The m >= 3 slab recursion batches the (m-1)-dimensional volume over
the prefix masks of the x-sorted set — O(S^2) slabs for m = 3 at S <= 32.

Precision contract: the twin computes in f32. The host scorer is f64, and
the chain accept test uses a 1e-12 epsilon that f32 cannot resolve near
convergence — so the twin is an opt-in backend
(``PhvContext(phv_backend="device")``), held against the host oracle to f32
tolerances, and the default stays host-exact.
"""

from __future__ import annotations

import numpy as np
import torch


def _hv_masked(pts: torch.Tensor, mask: torch.Tensor,
               ref: torch.Tensor) -> torch.Tensor:
    """Hypervolume of the masked rows of each ``pts`` w.r.t. ``ref``.

    ``pts`` (..., S, m) must already be clipped to ``ref``; ``mask`` (..., S)
    marks the valid rows, the others are replaced by ``ref`` (zero
    contribution). The recursion is on the static trailing-dimension count,
    as in pareto._hso: 1-D closed form, 2-D staircase, m >= 3 x-sorted
    slabs, every data-dependent set size replaced by masking. Returns the
    (...,) volumes."""
    m = pts.shape[-1]
    p = torch.where(mask[..., None], pts, ref)
    if m == 1:
        return torch.clamp(ref[0] - p[..., 0].amin(dim=-1), min=0.0)
    order = torch.argsort(p[..., 0], dim=-1, stable=True)
    p = torch.take_along_dim(p, order[..., None], dim=-2)
    x = p[..., 0]
    x_hi = torch.cat([x[..., 1:], ref[:1].expand(*x.shape[:-1], 1)], dim=-1)
    if m == 2:
        ymin = torch.cummin(p[..., 1], dim=-1).values
        return ((x_hi - x) * (ref[1] - ymin)).sum(dim=-1)
    s = p.shape[-2]
    # prefix[i] = sorted rows 0..i: one (m-1)-dimensional slab per row.
    prefix = torch.ones((s, s), dtype=torch.bool, device=p.device).tril()
    rest = p[..., None, :, 1:].expand(*p.shape[:-2], s, s, m - 1)
    sub = _hv_masked(rest, prefix.expand(*p.shape[:-2], s, s), ref[1:])
    return ((x_hi - x) * sub).sum(dim=-1)


def _phv_batch(setp: torch.Tensor, smask: torch.Tensor, cands: torch.Tensor,
               ref: torch.Tensor) -> torch.Tensor:
    """HV(S ∪ {c}) = HV(S) + box(c) − HV(S clipped into box(c)); covered
    candidates collapse to HV(S) — the exclusive-contribution identity of
    pareto.hypervolume_with_batch, batched over the candidates."""
    c = torch.minimum(cands, ref)
    box = torch.clamp(ref - c, min=0.0).prod(dim=1)
    sp = torch.minimum(setp, ref)
    base = _hv_masked(sp, smask, ref)
    le = (sp[None, :, :] <= c[:, None, :]).all(dim=2) & smask[None, :]
    covered = le.any(dim=1)
    b = c.shape[0]
    clipped = torch.maximum(sp[None, :, :], c[:, None, :])
    vol_sub = _hv_masked(clipped, smask.expand(b, -1), ref)
    return torch.where(covered | (box <= 0), base, base + box - vol_sub)


def hypervolume_with_batch_torch(points: np.ndarray, cands: np.ndarray,
                                 ref: np.ndarray, *, device,
                                 max_set: int = 32) -> np.ndarray:
    """Device twin of :func:`pareto.hypervolume_with_batch` — (B,) array of
    HV(points ∪ {c}) computed in f32 on ``device``. Pads the set to
    ``max_set`` quanta and the batch to a power of two first."""
    pts = np.atleast_2d(np.asarray(points, np.float32))
    cnd = np.atleast_2d(np.asarray(cands, np.float32))
    ref32 = np.asarray(ref, np.float32)
    m = ref32.shape[0]
    s = pts.shape[0] if pts.size else 0
    sp = max(max_set, 1 << max(0, (s - 1).bit_length())) if s else max_set
    setp = np.broadcast_to(ref32, (sp, m)).copy()
    if s:
        setp[:s] = pts
    smask = np.zeros(sp, bool)
    smask[:s] = True
    b = cnd.shape[0]
    bp = 1 << max(0, (b - 1).bit_length())
    cp = np.broadcast_to(ref32, (bp, m)).copy()
    cp[:b] = cnd
    out = _phv_batch(torch.as_tensor(setp, device=device),
                     torch.as_tensor(smask, device=device),
                     torch.as_tensor(cp, device=device),
                     torch.as_tensor(ref32, device=device))
    return out[:b].cpu().numpy().astype(np.float64)
