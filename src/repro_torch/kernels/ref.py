"""Plain PyTorch versions of the seven CUDA kernels.

The kernel wrappers in :mod:`repro_torch.kernels.ops` run these for tensors
on the CPU; ``chip_smoke.py`` calls them directly on CUDA tensors to hold
each kernel against them. Each repeats its kernel's arithmetic, in the same
order where the order shows in the bits (the forest's tree mean, the walk's
flow sums), so a kernel and its plain version agree bit for bit where
their inputs do."""

from __future__ import annotations

import torch

INF = 1.0e9

#: Largest N served by the one-shot (B, N, N, N) broadcast; above it the
#: k-blocked loop bounds the transient (bit-equal: min is exact).
DENSE_NMAX = 256


def minplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, N) min-plus product out[b,i,j] = min_k a[b,i,k] + b[b,k,j]."""
    n = a.shape[-1]
    if n <= DENSE_NMAX:
        return (a[:, :, :, None] + b[:, None, :, :]).amin(dim=2)
    bk = 16
    out = torch.full_like(a, float("inf"))
    for k0 in range(0, n, bk):
        part = (a[:, :, k0:k0 + bk, None] + b[:, None, k0:k0 + bk, :]).amin(2)
        out = torch.minimum(out, part)
    return out


def apsp_ref(cost: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Batched APSP by ``n_iters`` min-plus squarings. It stops at the first
    squaring that changes no bit of the batch: squaring is a function of the
    matrix alone, so every later one would return the same bits."""
    d = cost
    for _ in range(n_iters):
        nxt = minplus_ref(d, d)
        fixed = torch.equal(nxt.view(torch.int32), d.view(torch.int32))
        d = nxt
        if fixed:
            break
    return d


def forest_leaves_ref(thr, feat, child, x, depth: int) -> torch.Tensor:
    """(T, B) leaf index per (tree, sample): ``depth`` levels of
    ``go_right = x[feat] > thr`` on the (T, M) tree-local layout, child
    (T, 2M) interleaved (left, right), self-looping leaves."""
    t = thr.shape[0]
    b = x.shape[0]
    idx = torch.zeros((t, b), dtype=torch.long, device=x.device)
    cols = torch.arange(b, device=x.device)[None, :].expand(t, b)
    featl, childl = feat.long(), child.long()
    for _ in range(depth):
        fi = featl.gather(1, idx)
        xv = x[cols, fi]
        right = (xv > thr.gather(1, idx)).long()
        idx = childl.gather(1, 2 * idx + right)
    return idx


def _tree_mean(value, idx) -> torch.Tensor:
    vals = value.gather(1, idx)                       # (T, B)
    acc = torch.zeros(vals.shape[1], dtype=vals.dtype, device=vals.device)
    for t in range(vals.shape[0]):                    # trees ascending
        acc = acc + vals[t]
    # A true f32 division, as the kernels do: PyTorch on CUDA divides by a
    # Python scalar as a product with its f32 reciprocal (1 ulp apart).
    return acc / torch.full_like(acc, vals.shape[0])


def forest_predict_ref(thr, feat, child, value, x, depth: int) -> torch.Tensor:
    """(B,) f32 forest mean over T trees of an already-normalized batch."""
    return _tree_mean(value, forest_leaves_ref(thr, feat, child, x, depth))


def score_block_max_ref(thr, feat, child, value, xm, xs, x, n_real: int,
                        depth: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(max value, first argmax) over the first ``n_real`` rows of the
    forest mean of ``(x - xm) / xs``; later rows are -inf."""
    xn = (x - xm) / xs
    vals = forest_predict_ref(thr, feat, child, value, xn, depth)
    vals[n_real:] = float("-inf")
    j = torch.argmax(vals)
    return vals[j], j.to(torch.int32)


def index_add_in_order(out: torch.Tensor, idx: torch.Tensor,
                       src: torch.Tensor, rounds: bool | None = None) -> None:
    """``out[idx[i]] += src[i]`` on a 1-D ``out`` for i ascending: the
    addends of one index sum in the order they are given. index_add_ does
    so on the CPU; on CUDA it adds with atomics in no fixed order. There
    (or with ``rounds=True``) the adds run in rounds, round k adding the
    k-th addend of each index, so no round holds an index twice."""
    if rounds is None:
        rounds = out.device.type != "cpu"
    if not rounds or idx.numel() == 0:
        out.index_add_(0, idx, src)
        return
    order = torch.sort(idx, stable=True).indices
    s = idx[order]
    pos = torch.arange(s.numel(), device=s.device)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start
    for k in range(int(rank.max()) + 1):
        sel = rank == k
        out.index_add_(0, idx[sel], src[sel])


def walk_ref(nh: torch.Tensor, f: torch.Tensor, delay: torch.Tensor,
             max_hops: int):
    """Batched deterministic path walk.

    nh (B, N, N) int next hops, f (B, N, N) f32 slot traffic, delay (N, N)
    f32 wire delay. Returns (hops i32, delay sums f32, directed util f32,
    visits f32 incl. the destination router, all_done i32), each with the
    batch in front. hops and delay follow the pairs in path order; util and
    visits sum in-tree flows in the kernel's order (see csrc/walk.cu)."""
    bsz, n, _ = nh.shape
    dev = nh.device
    nhl = nh.long()
    ar = torch.arange(n, device=dev)
    dst = ar[None, None, :].expand(bsz, n, n)
    cur = ar[None, :, None].expand(bsz, n, n).clone()
    bidx = torch.arange(bsz, device=dev)[:, None, None]
    hops = torch.zeros((bsz, n, n), dtype=torch.int32, device=dev)
    dsum = torch.zeros((bsz, n, n), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(max_hops):
        done = cur == dst
        nxt = nhl[bidx, cur, dst]
        hops += (~done).to(torch.int32)
        dsum = dsum + torch.where(done, zero, delay[cur, nxt])
        cur = torch.where(done, cur, nxt)
    all_done = (cur == dst).all(dim=2).all(dim=1).to(torch.int32)

    # In-tree flows toward each destination, leaves in: a node one hop
    # further hands its (final) flow to its parent, children ascending —
    # the adds run in index order, which is (b, v, d) row-major, i.e. v
    # ascending for a fixed parent.
    flow = f.clone()
    flat = flow.view(-1)
    hopsl = hops.long()
    par_hops = hopsl.gather(1, nhl)          # hops[b, nh[b,v,d], d]
    for level in range(max_hops - 1, 0, -1):
        bi, vi, di = torch.nonzero((hopsl == level + 1) & (par_hops == level),
                                   as_tuple=True)
        if bi.numel():
            pi = nhl[bi, vi, di]
            index_add_in_order(flat, (bi * n + pi) * n + di,
                               flow[bi, vi, di])

    off = ~torch.eye(n, dtype=torch.bool, device=dev)[None].expand(bsz, n, n)
    bi, ui, di = torch.nonzero(off, as_tuple=True)
    src = flow[bi, ui, di]
    util = torch.zeros(bsz * n * n, dtype=torch.float32, device=dev)
    index_add_in_order(util, (bi * n + ui) * n + nhl[bi, ui, di], src)
    vis = torch.zeros(bsz * n, dtype=torch.float32, device=dev)
    index_add_in_order(vis, bi * n + ui, src)
    col = torch.zeros((bsz, n), dtype=torch.float32, device=dev)
    for s in range(n):                       # sources ascending
        col = col + f[:, s, :]
    visits = vis.view(bsz, n) + col
    return hops, dsum, util.view(bsz, n, n), visits, all_done


# ------------------------------------------------------------------- K5
NEG_INF = -1.0e30


def nsga2_rank_ref(objs: torch.Tensor):
    """(rank, crowding) twin of the numpy pair on ``objs``' device. Peeling
    runs n rounds (at most n fronts) without reading anything back; the
    argsorts are stable, as numpy's ``kind="stable"`` is."""
    n, m = objs.shape
    dev = objs.device
    le = (objs[:, None, :] <= objs[None, :, :]).all(dim=-1)
    lt = (objs[:, None, :] < objs[None, :, :]).any(dim=-1)
    idx = torch.arange(n, device=dev)
    dom = (le & lt) | (le & ~lt & (idx[:, None] < idx[None, :]))

    rank = torch.full((n,), -1, dtype=torch.int32, device=dev)
    n_dom = dom.sum(dim=0)
    for r in range(n):
        front = (rank < 0) & (n_dom == 0)
        rank = torch.where(front, r, rank)
        n_dom = n_dom - (dom & front[:, None]).sum(dim=0)

    crowd = torch.zeros(n, dtype=objs.dtype, device=dev)
    for j in range(m):
        order = torch.argsort(objs[:, j], stable=True)
        col = objs[order, j]
        rng_j = col[-1] - col[0] + 1e-12
        contrib = torch.zeros(n, dtype=objs.dtype, device=dev)
        if n > 2:
            contrib[order[1:-1]] = (col[2:] - col[:-2]) / rng_j
        crowd = crowd + contrib
        crowd[order[0]] = float("inf")
        crowd[order[-1]] = float("inf")
    return rank, crowd


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None
                  ) -> torch.Tensor:
    """GQA attention: q (B, H, Sq, D), k/v (B, KH, Sk, D) -> (B, H, Sq, D)
    in q's dtype. Logits and softmax in f32, scale D^-0.5; masked logits
    are -1e30 and their probabilities 0, so a row with no valid key is 0.
    q head h reads kv head h // (H // KH), folded by a reshape (repeated KV
    is never built)."""
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kh, h // kh, sq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * (d ** -0.5)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros((), device=q.device))
    y = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return y.reshape(b, h, sq, d).to(q.dtype)


# ------------------------------------------------------------------- K6
def ssd_ref(x, dt, a, b, c, d, return_state: bool = False):
    """Sequential SSD recurrence, the ground truth: x (B,S,H,P), dt (B,S,H),
    a (H,), b/c (B,S,N), d (H,). Returns y (B,S,H,P) in x's dtype, plus the
    final state (B,H,N,P) f32 with ``return_state``."""
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a[None, :])               # (B,H)
        upd = torch.einsum("bn,bhp->bhnp", bf[:, t],
                           xf[:, t] * dtf[:, t, :, None])
        state = decay[..., None, None] * state + upd
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], state))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(xf)
    y = (y + d[None, None, :, None] * xf).to(x.dtype)
    return (y, state) if return_state else y


def ssd_chunked_ref(x, dt, a, b, c, d, *, chunk: int = 64,
                    return_state: bool = False):
    """Chunk-parallel SSD (the kernel's math, S a multiple of ``chunk``):
    the intra-chunk dual form plus the chunk states carried in order. Every
    exponent it takes is <= 0."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtf = dt.float().reshape(bsz, nc, chunk, h)
    bf = b.float().reshape(bsz, nc, chunk, n)
    cf = c.float().reshape(bsz, nc, chunk, n)

    sc = torch.cumsum(dtf * a[None, None, None, :], dim=2)   # (B,C,Q,H)
    tril = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    g = torch.einsum("bcqn,bckn->bcqk", cf, bf)
    # The mask goes in before the exponential: above the diagonal
    # s_i - s_j > 0 and exp overflows once a chunk's decay passes e^88,
    # where masking after it (the reference's order) gives inf * 0 = NaN.
    seg = torch.where(tril[None, None, :, :, None],
                      sc[:, :, :, None, :] - sc[:, :, None, :, :],
                      float("-inf"))
    w = (g[..., None] * torch.exp(seg)
         * dtf[:, :, None, :, :])                             # (B,C,Q,K,H)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", w, xf)

    to_end = torch.exp(sc[:, :, -1:, :] - sc) * dtf           # (B,C,Q,H)
    chunk_state = torch.einsum("bcqn,bcqhp->bchnp", bf,
                               xf * to_end[..., None])
    chunk_decay = torch.exp(sc[:, :, -1, :])                  # (B,C,H)
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    befores = []
    for ci in range(nc):
        befores.append(state)
        state = chunk_decay[:, ci, :, None, None] * state + chunk_state[:, ci]
    h_before = torch.stack(befores, dim=1)                    # (B,C,H,N,P)
    cexp = cf[:, :, :, None, :] * torch.exp(sc)[..., None]    # (B,C,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", cexp, h_before)
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    y = (y + d[None, None, :, None] * x.float()).to(x.dtype)
    return (y, state) if return_state else y


def ssd_padded_ref(x, dt, a, b, c, d, *, chunk: int = 64,
                   return_state: bool = False):
    """Plain version of the CUDA kernel: S padded up to a multiple of
    ``chunk`` with zero rows (dt = x = B = C = 0, which decay by exp(0) = 1
    and add 0, so the final state is unchanged), the chunked form, then the
    padded rows of y dropped."""
    s = x.shape[1]
    pad = -s % chunk
    if pad:
        x, dt, b, c = (torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, b, c))
    out = ssd_chunked_ref(x, dt, a, b, c, d, chunk=chunk,
                          return_state=return_state)
    if return_state:
        return out[0][:, :s], out[1]
    return out[:, :s]
