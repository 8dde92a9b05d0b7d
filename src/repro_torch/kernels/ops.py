"""Kernel wrappers: the device of the input decides.

For tensors on the CPU each wrapper runs its plain version
(:mod:`repro_torch.kernels.ref`). For CUDA tensors it launches the
hand-written kernel (``csrc/*.cu``, built at first use by
:mod:`repro_torch.kernels.build`) or raises; there is no fallback. Every
wrapper counts its kernel launches in ``KERNELS[name].launches``, adding
one where it launches and nowhere else."""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


@dataclasses.dataclass
class Kernel:
    """One CUDA kernel of the port: where it lives, which TPU kernel it
    replaces, and how often it was launched."""

    name: str
    source: str
    replaces: str
    launches: int = 0


KERNELS = {k.name: k for k in (
    Kernel("minplus", "src/repro_torch/csrc/minplus.cu",
           "src/repro/kernels/minplus.py:50"),
    Kernel("forest_predict", "src/repro_torch/csrc/forest.cu",
           "src/repro/kernels/forest.py:68"),
    Kernel("score_block_max", "src/repro_torch/csrc/forest.cu",
           "src/repro/kernels/stage_fused.py:77"),
    Kernel("walk", "src/repro_torch/csrc/walk.cu",
           "src/repro/kernels/link_util.py:81"),
    Kernel("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention.py:82"),
    Kernel("ssd", "src/repro_torch/csrc/ssd.cu",
           "src/repro/kernels/ssd.py:76"),
)}

_SIGS = {
    "minplus_launch": ("minplus", [_P, _P, _P, _I, _I, _P]),
    "apsp_launch": ("minplus", [_P, _P, _I, _I, _I, _P]),
    "forest_predict_launch": ("forest", [_P] * 6 + [_I] * 5 + [_P]),
    "score_block_max_launch": ("forest", [_P] * 7 + [_I] * 6 + [_P] * 5),
    "forest_blocks": ("forest", [_I]),
    "walk_launch": ("walk", [_P] * 3 + [_I] * 3 + [_P] * 7),
    "flash_attention_launch": ("flash_attention",
                               [_P] * 4 + [_I] * 7 + [_L] * 9 + [_F]
                               + [_I] * 2 + [_P]),
    "ssd_launch": ("ssd", [_P] * 8 + [_I] * 6 + [_P]),
}
_fns: dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launches() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def _fn(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        lib_name, argtypes = _SIGS[symbol]
        fn = getattr(build.library(lib_name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU inputs; raises on a mix or on
    any other device."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"kernel inputs must all be on one CPU or CUDA device, "
                     f"got {sorted(str(t.device) for t in tensors)}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(kernel: str, symbol: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _fn(symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")
    KERNELS[kernel].launches += 1


# ------------------------------------------------------------------- K1
def _minplus_into(a, b, out) -> None:
    bsz, n, _ = a.shape
    _launch("minplus", "minplus_launch", a.device, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), bsz, n)


def _check_square_batch(*tensors) -> None:
    shape = tensors[0].shape
    if len(shape) != 3 or shape[1] != shape[2]:
        raise ValueError(f"expected a (B, N, N) batch, got {tuple(shape)}")
    for i, t in enumerate(tensors):
        _check(t, f"arg{i}", torch.float32, shape)


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, N) min-plus product (K1)."""
    if not _on_cuda(a, b):
        return ref.minplus_ref(a, b)
    _check_square_batch(a, b)
    out = torch.empty_like(a)
    _minplus_into(a, b, out)
    return out


#: Largest N whose whole APSP runs in one launch, the design's matrix in
#: shared memory; above it one launch per squaring.
APSP_MAX_N = 128


def apsp(cost: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Batched APSP by ``n_iters`` min-plus squarings (K1), out of place
    between two buffers. A design stops at the first squaring that changes
    none of its entries: every later one would return the same bits."""
    if not _on_cuda(cost):
        return ref.apsp_ref(cost, n_iters)
    _check_square_batch(cost)
    if n_iters == 0:
        return cost.clone()
    bsz, n, _ = cost.shape
    if n <= APSP_MAX_N:
        out = torch.empty_like(cost)
        if bsz:
            _launch("minplus", "apsp_launch", cost.device, cost.data_ptr(),
                    out.data_ptr(), bsz, n, n_iters)
        return out
    bufs = (torch.empty_like(cost), torch.empty_like(cost))
    src = cost
    for i in range(n_iters):
        dst = bufs[i % 2]
        _minplus_into(src, src, dst)
        src = dst
    return src


# -------------------------------------------------------------- K2 / K3
def _check_forest(thr, feat, child, value):
    t, m = thr.shape
    _check(thr, "threshold", torch.float32, (t, m))
    _check(feat, "feature", torch.int32, (t, m))
    _check(child, "child", torch.int32, (t, 2 * m))
    _check(value, "value", torch.float32, (t, m))
    return t, m


def forest_predict(thr, feat, child, value, x, depth: int) -> torch.Tensor:
    """(B,) f32 forest mean of an already-normalized (B, F) batch (K2)."""
    if not _on_cuda(thr, feat, child, value, x):
        return ref.forest_predict_ref(thr, feat, child, value, x, depth)
    t, m = _check_forest(thr, feat, child, value)
    rows, f = x.shape
    _check(x, "x", torch.float32, (rows, f))
    out = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        _launch("forest_predict", "forest_predict_launch", x.device,
                thr.data_ptr(), feat.data_ptr(), child.data_ptr(),
                value.data_ptr(), x.data_ptr(), out.data_ptr(), rows, t, m,
                f, depth)
    return out


def score_block_max(thr, feat, child, value, xm, xs, x, n_real: int,
                    depth: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(max value, first argmax) over rows < ``n_real`` of the forest mean
    of ``(x - xm) / xs`` (K3). Returns 0-d f32 and i32 tensors."""
    rows, f = x.shape
    if not 1 <= n_real <= rows:
        raise ValueError(f"n_real must be in [1, {rows}], got {n_real}")
    if not _on_cuda(thr, feat, child, value, xm, xs, x):
        return ref.score_block_max_ref(thr, feat, child, value, xm, xs, x,
                                       n_real, depth)
    t, m = _check_forest(thr, feat, child, value)
    _check(x, "x", torch.float32, (rows, f))
    _check(xm, "xm", torch.float32, (f,))
    _check(xs, "xs", torch.float32, (f,))
    blocks = _fn("forest_blocks")(rows)
    dev = x.device
    part_val = torch.empty(blocks, dtype=torch.float32, device=dev)
    part_arg = torch.empty(blocks, dtype=torch.int32, device=dev)
    out_val = torch.empty((), dtype=torch.float32, device=dev)
    out_arg = torch.empty((), dtype=torch.int32, device=dev)
    _launch("score_block_max", "score_block_max_launch", dev,
            thr.data_ptr(), feat.data_ptr(), child.data_ptr(),
            value.data_ptr(), xm.data_ptr(), xs.data_ptr(), x.data_ptr(),
            rows, n_real, t, m, f, depth, part_val.data_ptr(),
            part_arg.data_ptr(), out_val.data_ptr(), out_arg.data_ptr())
    return out_val, out_arg


# ------------------------------------------------------------------- K4
def walk(nh: torch.Tensor, f: torch.Tensor, delay: torch.Tensor,
         max_hops: int):
    """Batched path walk (K4): (hops i32, delay sums, directed util,
    visits, all_done i32) for next hops nh (B, N, N) i32, slot traffic f
    (B, N, N) f32 and wire delay (N, N) f32.

    On the card one call is two launches, counted as one: the walks and
    in-tree flows per (design, destination), then util and visits per
    (design, slot)."""
    if not _on_cuda(nh, f, delay):
        return ref.walk_ref(nh, f, delay, max_hops)
    bsz, n, _ = nh.shape
    if n > 1024:
        raise ValueError(f"walk kernel takes N <= 1024 slots, got {n}")
    _check(nh, "nh", torch.int32, (bsz, n, n))
    _check(f, "f", torch.float32, (bsz, n, n))
    _check(delay, "delay", torch.float32, (n, n))
    dev = nh.device
    hops = torch.empty((bsz, n, n), dtype=torch.int32, device=dev)
    dsum = torch.empty((bsz, n, n), dtype=torch.float32, device=dev)
    util = torch.empty((bsz, n, n), dtype=torch.float32, device=dev)
    visits = torch.empty((bsz, n), dtype=torch.float32, device=dev)
    done = torch.empty(bsz, dtype=torch.int32, device=dev)
    # (parent, flow) of every pair between the kernel's two passes, and
    # one all-done flag per block of the first.
    scratch = torch.empty(bsz * (2 * n * n + n), dtype=torch.int32,
                          device=dev)
    if bsz:
        _launch("walk", "walk_launch", dev, nh.data_ptr(), f.data_ptr(),
                delay.data_ptr(), bsz, n, max_hops, hops.data_ptr(),
                dsum.data_ptr(), util.data_ptr(), visits.data_ptr(),
                done.data_ptr(), scratch.data_ptr())
    return hops, dsum, util, visits, done


# ------------------------------------------------------------------- K5
#: Largest head dimension the attention kernel takes (bf16: padded to a
#: multiple of 16 on the tensor cores; f32: 8 columns per lane).
ATTN_MAX_HEAD_DIM = 256
_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None) -> torch.Tensor:
    """GQA attention forward (K5): q (B, H, Sq, D), k/v (B, KH, Sk, D), bf16
    or f32, any strides with a contiguous last dimension, D <= 256. Returns
    (B, H, Sq, D) in q's dtype. ``window`` None means no window.

    On the card the dtype picks the kernel: bf16 runs on the tensor cores
    (bf16 operands, f32 accumulators, probabilities as two bf16 terms
    hi + lo in p.v), f32 on the CUDA cores in f32."""
    if not _on_cuda(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    b, h, sq, d = q.shape
    _, kh, sk, _ = k.shape
    if d > ATTN_MAX_HEAD_DIM:
        raise ValueError(f"attention kernel takes head_dim <= "
                         f"{ATTN_MAX_HEAD_DIM}, got {d}")
    if q.dtype not in _ATTN_DTYPES:
        raise TypeError(f"attention kernel takes f32 or bf16, got {q.dtype}")
    if kh < 1 or h % kh:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {kh}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    for name, t, shape in (("k", k, (b, kh, sk, d)), ("v", v, (b, kh, sk, d))):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: expected {q.dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: last dimension must be contiguous")
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if out.numel():
        _launch("flash_attention", "flash_attention_launch", q.device,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _ATTN_DTYPES[q.dtype], b, h, kh, sq, sk, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                d ** -0.5, int(causal), window or 0)
    return out


# ------------------------------------------------------------------- K6
#: Largest chunk and head dim (P), and state size (N), the SSD kernel takes.
SSD_MAX_CHUNK = 64
SSD_MAX_P = 64
SSD_MAX_N = 128


def ssd(x, dt, a, b, c, d, *, chunk: int = 64, return_state: bool = False):
    """Mamba-2 SSD chunked scan (K6): x (B,S,H,P), dt (B,S,H), a (H,), b/c
    (B,S,N), d (H,), all f32. Returns y (B,S,H,P), plus the final state
    (B,H,N,P) with ``return_state``.

    On the card one block runs 3 heads of a batch row (2 at N > 64),
    sharing each chunk's C B^T, with every f32 product as three TF32
    products on the tensor cores.

    On the CPU this keeps the reference's choice: the chunked form when S is
    a multiple of ``chunk`` above it, else the sequential scan. The kernel
    takes any S: a ragged tail runs as a chunk padded with zero rows, which
    leave the state unchanged (plain version: ``ref.ssd_padded_ref``)."""
    if not _on_cuda(x, dt, a, b, c, d):
        s = x.shape[1]
        if s % chunk == 0 and s > chunk:
            return ref.ssd_chunked_ref(x, dt, a, b, c, d, chunk=chunk,
                                       return_state=return_state)
        return ref.ssd_ref(x, dt, a, b, c, d, return_state=return_state)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if not 1 <= chunk <= SSD_MAX_CHUNK:
        raise ValueError(f"ssd kernel takes 1 <= chunk <= {SSD_MAX_CHUNK}, "
                         f"got {chunk}")
    if p > SSD_MAX_P or n > SSD_MAX_N:
        raise ValueError(f"ssd kernel takes P <= {SSD_MAX_P} and N <= "
                         f"{SSD_MAX_N}, got P={p}, N={n}")
    _check(x, "x", torch.float32, (bsz, s, h, p))
    _check(dt, "dt", torch.float32, (bsz, s, h))
    _check(a, "a", torch.float32, (h,))
    _check(b, "b", torch.float32, (bsz, s, n))
    _check(c, "c", torch.float32, (bsz, s, n))
    _check(d, "d", torch.float32, (h,))
    y = torch.empty_like(x)
    state = (torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
             if return_state else None)
    if bsz and h:
        _launch("ssd", "ssd_launch", x.device, x.data_ptr(), dt.data_ptr(),
                a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                y.data_ptr(), state.data_ptr() if return_state else None,
                bsz, s, h, p, n, chunk)
    return (y, state) if return_state else y
