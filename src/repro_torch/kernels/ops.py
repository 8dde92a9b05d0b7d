"""Kernel wrappers: the device of the input decides.

For tensors on the CPU each wrapper runs its plain version
(:mod:`repro_torch.kernels.ref`). For CUDA tensors it launches the
hand-written kernel (``csrc/*.cu``, built at first use by
:mod:`repro_torch.kernels.build`) or raises; there is no fallback. Every
wrapper counts its kernel launches in ``KERNELS[name].launches``, adding
one where it launches and nowhere else. A launch enqueued while a CUDA
graph is captured (inside :func:`recorded`) runs only when the graph
replays, so it counts there, through :func:`replayed`.

Training reaches K5 and K6 through ``torch.autograd.Function``s, the
counterparts of the reference's custom_vjps (``src/repro/kernels/ops.py``
:55-107): the forward launches the kernel, and the backward recomputes the
plain version from the saved inputs and differentiates it. The reference
has no backward kernel, so none is ported.

Inside an active work log (:func:`work_log`, which the pod tools'
counter installs) every wrapper also records its kernel's work, a
:class:`Work` (kernel, FLOPs, bytes, dtype), on CUDA inputs and on meta
inputs alike. Meta inputs take the card's path there, its argument checks
and its output allocations, and launch nothing: the result is a meta
tensor of the kernel's output shape. Outside a work log, meta inputs
raise like any other device that is not the CPU or one CUDA device."""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import threading

import numpy as np
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
    # The reference's jitted jnp twin of NSGA-II's selection scoring, not a
    # Pallas kernel.
    Kernel("nsga2_rank", "src/repro_torch/csrc/nsga2.cu",
           "src/repro/core/nsga2.py:90"),
)}

_SIGS = {
    "minplus_launch": ("minplus", [_P, _P, _P, _I, _I, _P]),
    "apsp_launch": ("minplus", [_P, _P, _I, _I, _I, _P]),
    "forest_predict_launch": ("forest", [_P] * 4 + [_I] * 8 + [_P]),
    "score_block_max_launch": ("forest", [_P] * 5 + [_I] * 8 + [_P] * 4),
    "walk_launch": ("walk", [_P] * 3 + [_I] * 3 + [_P] * 7),
    "flash_attention_launch": ("flash_attention",
                               [_P] * 4 + [_I] * 7 + [_L] * 9 + [_F]
                               + [_I] * 2 + [_P]),
    "ssd_launch": ("ssd", [_P] * 8 + [_I] * 6 + [_P]),
    "nsga2_rank_launch": ("nsga2", [_P, _I, _I, _P, _P, _P]),
}
_fns: dict[str, ctypes._CFuncPtr] = {}


@dataclasses.dataclass(frozen=True)
class Work:
    """One kernel call's work: ``flops`` counted as PERF.md's bounds count
    them, in ``dtype`` ("bf16", "f32", or "tf32" for K6's 3xTF32 products:
    three TF32 products per f32 product), and ``bytes``, each input read
    once and each output written once. K1 and K4 count f32 operations
    outside the tensor cores; K1 counts every squaring it is asked for
    (an upper bound: a design stops at its fixed point) and K4 the work
    that does not depend on the path lengths."""

    kernel: str
    flops: float
    bytes: float
    dtype: str


#: The records of the active work log, or None. A module global: K5 and
#: K6 run in the backward pass's recompute on autograd's thread.
_WORK = None


@contextlib.contextmanager
def work_log(records: list):
    """Append a :class:`Work` to ``records`` for every kernel call made
    inside, and let meta inputs take the card's path."""
    global _WORK
    prev, _WORK = _WORK, records
    try:
        yield records
    finally:
        _WORK = prev


@dataclasses.dataclass
class Record:
    """The launches and work a CUDA graph's capture enqueued, which each
    of its replays runs."""

    launches: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    works: list = dataclasses.field(default_factory=list)


#: The open :func:`recorded` block's record, per thread: a capture on one
#: thread leaves another thread's launches where they are.
_capturing = threading.local()


@contextlib.contextmanager
def recorded():
    """Inside, this thread's launches and work go to the returned
    :class:`Record` instead of ``KERNELS`` and the work log: a graph's
    capture enqueues kernels that run only when it replays."""
    prev = getattr(_capturing, "rec", None)
    _capturing.rec = rec = Record()
    try:
        yield rec
    finally:
        _capturing.rec = prev


def replayed(rec: Record) -> None:
    """Count a replay of the graph whose capture made ``rec``: its
    launches in ``KERNELS``, its work in the active work log."""
    for name, n in rec.launches.items():
        KERNELS[name].launches += n
    if _WORK is not None:
        _WORK.extend(rec.works)


def _work(kernel: str, flops: float, n_bytes: float, dtype: str) -> None:
    rec = getattr(_capturing, "rec", None)
    if rec is not None:
        rec.works.append(Work(kernel, float(flops), float(n_bytes), dtype))
    elif _WORK is not None:
        _WORK.append(Work(kernel, float(flops), float(n_bytes), dtype))


def dtype_name(dtype: torch.dtype) -> str:
    """The short name work is keyed by: "bf16", "f32", ..."""
    return {torch.bfloat16: "bf16", torch.float32: "f32",
            torch.float16: "f16"}.get(dtype, str(dtype))


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
    """True for CUDA inputs, and for meta inputs inside a work log (the
    card's path, launching nothing); False for CPU inputs; raises on a mix
    or on any other device."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    if types == {"meta"} and _WORK is not None:
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
    """Launch on the current stream of ``device`` (a tensor's, so its index
    is set), made the current device first where it is not. On the meta
    device nothing is launched or counted."""
    if device.type == "meta":
        return None
    idx = device.index
    if idx != torch.cuda.current_device():
        with torch.cuda.device(idx):
            return _launch(kernel, symbol, device, *args)
    err = _fn(symbol)(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")
    rec = getattr(_capturing, "rec", None)
    if rec is None:
        KERNELS[kernel].launches += 1
    else:
        rec.launches[kernel] += 1


# ------------------------------------------------------------------- K1
def _minplus_work(bsz: int, n: int, squarings: int) -> None:
    """An add and a min per (i, k, j) and squaring; the batch read and
    written once."""
    _work("minplus", 2 * squarings * bsz * n ** 3, 2 * 4 * bsz * n * n,
          "f32")


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
    _minplus_work(a.shape[0], a.shape[1], 1)
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
    _minplus_work(bsz, n, n_iters)
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
#: Rows of the batch one thread-block cluster of the forest kernels walks.
FOREST_BLOCK_ROWS = 64
#: Most CTAs in a cluster; the trees are split among them.
FOREST_MAX_CLUSTER = 8
#: Largest slice of packed records and leaf values (bytes) that one CTA
#: keeps in shared memory; a forest whose slice is larger takes the "l2"
#: route, its records read through L2.
FOREST_SMEM_SLICE_MAX = 160 * 1024


@dataclasses.dataclass(frozen=True, eq=False)
class PackedForest:
    """A forest in the layout of kernels K2 and K3 on one device, built and
    checked once by :func:`pack_forest`.

    ``records`` (T, M, 4) i32 holds one 16-byte record per node: threshold
    bits, feature (clamped to 0 at leaves), left, right; M is padded to a
    multiple of 4 with records that no walk reaches. ``value`` (T, M) f32
    holds the leaf values. ``plain`` keeps the four (T, M) / (T, 2M)
    tensors it was packed from, which the plain versions take. The trees
    are split among ``cluster`` CTAs, CTA r taking :func:`tree_slice`."""

    records: torch.Tensor
    value: torch.Tensor
    plain: tuple
    depth: int
    n_features: int
    cluster: int
    route: str

    @property
    def n_trees(self) -> int:
        return self.records.shape[0]


def tree_slice(t_count: int, cluster: int, rank: int) -> tuple[int, int]:
    """Trees [t0, t1) that CTA ``rank`` of a forest cluster walks; no slice
    holds more than ceil(T / cluster) trees."""
    return rank * t_count // cluster, (rank + 1) * t_count // cluster


def _check_forest(thr, feat, child, value):
    t, m = thr.shape
    _check(thr, "threshold", torch.float32, (t, m))
    _check(feat, "feature", torch.int32, (t, m))
    _check(child, "child", torch.int32, (t, 2 * m))
    _check(value, "value", torch.float32, (t, m))
    return t, m


def pack_forest(thr, feat, child, value, depth: int) -> PackedForest:
    """Check the (T, M) forest tensors of ``RegressionForest.device_nodes``
    once and pack them into K2/K3's node records, on their device."""
    t, m = _check_forest(thr, feat, child, value)
    if t < 1 or m < 1 or depth < 0:
        raise ValueError(f"forest needs T >= 1 trees, M >= 1 nodes and "
                         f"depth >= 0, got T={t}, M={m}, depth={depth}")
    if int(child.min()) < 0 or int(child.max()) >= m or int(feat.min()) < 0:
        raise ValueError("forest: children must lie in [0, M) and features "
                         "be >= 0 (leaves clamped)")
    mp = -(-m // 4) * 4
    rec = torch.zeros((t, mp, 4), dtype=torch.int32, device=thr.device)
    rec[:, :m, 0] = thr.view(torch.int32)
    rec[:, :m, 1] = feat
    rec[:, :m, 2:] = child.view(t, m, 2)
    val = torch.zeros((t, mp), dtype=torch.float32, device=thr.device)
    val[:, :m] = value
    cluster = min(FOREST_MAX_CLUSTER, t)
    slice_bytes = -(-t // cluster) * mp * 20
    route = "smem" if slice_bytes <= FOREST_SMEM_SLICE_MAX else "l2"
    return PackedForest(rec, val, (thr, feat, child, value), depth,
                        int(feat.max()) + 1, cluster, route)


def _forest_args(forest: PackedForest, x: torch.Tensor) -> tuple:
    """The launch's forest and shape arguments after checking ``x``."""
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous (B, F) f32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[1] < forest.n_features:
        raise ValueError(f"x has {x.shape[1]} features, the forest reads "
                         f"{forest.n_features}")
    t, m = forest.value.shape
    return (forest.records.data_ptr(), forest.value.data_ptr(), t, m,
            x.shape[1], forest.depth, forest.cluster, FOREST_BLOCK_ROWS,
            int(forest.route == "smem"))


def _forest_work(kernel: str, forest: PackedForest, rows: int, f: int,
                 normalize: bool) -> None:
    """A compare per level and tree and an add per tree for each row (and
    with ``normalize`` a subtract and a divide per feature); 12 bytes of
    node record per level and 4 of leaf value per tree and row, the rows
    read once."""
    t, depth = forest.n_trees, forest.depth
    flops = rows * (t * (depth + 1) + (2 * f if normalize else 0))
    n_bytes = rows * (t * (12 * depth + 4) + 4 * f)
    # K3 reads the two (F,) normalizers and writes its 8-byte (max,
    # argmax); K2 writes a value per row.
    n_bytes += 8 * f + 8 if normalize else 4 * rows
    _work(kernel, flops, n_bytes, "f32")


def forest_predict_packed(forest: PackedForest, x: torch.Tensor
                          ) -> torch.Tensor:
    """(B,) f32 forest mean of an already-normalized (B, F) batch (K2)."""
    if not _on_cuda(forest.value, x):
        return ref.forest_predict_ref(*forest.plain, x, forest.depth)
    rec, val, t, m, f, depth, cl, br, route = _forest_args(forest, x)
    rows = x.shape[0]
    out = torch.empty(rows, dtype=torch.float32, device=x.device)
    _forest_work("forest_predict", forest, rows, f, False)
    if rows:
        _launch("forest_predict", "forest_predict_launch", x.device, rec,
                val, x.data_ptr(), out.data_ptr(), rows, t, m, f, depth, cl,
                br, route)
    return out


_fold_scratch: dict[torch.device, torch.Tensor] = {}


def score_block_max_packed(forest: PackedForest, xm, xs, x, n_real: int,
                           out: torch.Tensor) -> torch.Tensor:
    """(max value, first argmax) over rows < ``n_real`` of the forest mean
    of ``(x - xm) / xs`` (K3), written into ``out`` (2,) i32 as the value's
    f32 bits and the row: one 8-byte read-back. Returns ``out``.

    On the card the fold across clusters counts on a per-device scratch
    counter that every launch leaves at zero: calls on one device must be
    ordered on one stream, so a call on any stream but the device's
    default stream raises."""
    rows = x.shape[0]
    if not 1 <= n_real <= rows:
        raise ValueError(f"n_real must be in [1, {rows}], got {n_real}")
    if out.dtype != torch.int32 or out.shape != (2,) or out.stride() != (1,):
        raise ValueError("out: expected a contiguous (2,) i32 tensor")
    if not _on_cuda(forest.value, xm, xs, x, out):
        v, j = ref.score_block_max_ref(*forest.plain, xm, xs, x, n_real,
                                       forest.depth)
        out.view(torch.float32)[0] = v
        out[1] = j
        return out
    dev = x.device
    if dev.type == "cuda" and (torch.cuda.current_stream(dev)
                               != torch.cuda.default_stream(dev)):
        raise RuntimeError(
            "score_block_max: K3's fold counter is shared by every launch on "
            f"{dev}; call it on the device's default stream, not "
            f"{torch.cuda.current_stream(dev)}")
    rec, val, t, m, f, depth, cl, br, route = _forest_args(forest, x)
    _check(xm, "xm", torch.float32, (f,))
    _check(xs, "xs", torch.float32, (f,))
    n_clusters = -(-n_real // br)
    _forest_work("score_block_max", forest, n_real, f, True)
    ws = _fold_scratch.get(dev)
    if ws is None or ws.numel() < 1 + 2 * n_clusters:
        ws = _fold_scratch[dev] = torch.zeros(1 + 2 * n_clusters,
                                              dtype=torch.int32, device=dev)
    ptr = out.data_ptr()
    _launch("score_block_max", "score_block_max_launch", dev, rec, val,
            xm.data_ptr(), xs.data_ptr(), x.data_ptr(), n_real, t, m, f,
            depth, cl, br, route, ws.data_ptr(), ptr, ptr + 4)
    return out


def forest_predict(thr, feat, child, value, x, depth: int) -> torch.Tensor:
    """(B,) f32 forest mean of an already-normalized (B, F) batch (K2),
    from the four forest tensors: packed per call on the card (the main
    path packs once, :meth:`RegressionForest.packed`)."""
    if not _on_cuda(thr, feat, child, value, x):
        return ref.forest_predict_ref(thr, feat, child, value, x, depth)
    return forest_predict_packed(
        pack_forest(thr, feat, child, value, depth), x)


def score_block_max(thr, feat, child, value, xm, xs, x, n_real: int,
                    depth: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(max value, first argmax) over rows < ``n_real`` of the forest mean
    of ``(x - xm) / xs`` (K3), from the four forest tensors (packed per
    call on the card). Returns 0-d f32 and i32 tensors."""
    rows = x.shape[0]
    if not 1 <= n_real <= rows:
        raise ValueError(f"n_real must be in [1, {rows}], got {n_real}")
    if not _on_cuda(thr, feat, child, value, xm, xs, x):
        return ref.score_block_max_ref(thr, feat, child, value, xm, xs, x,
                                       n_real, depth)
    out = torch.empty(2, dtype=torch.int32, device=x.device)
    score_block_max_packed(pack_forest(thr, feat, child, value, depth), xm,
                           xs, x, n_real, out)
    return out.view(torch.float32)[0], out[1]


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
    # Per pair one add into the parent's flow, util, visits and a column
    # sum; the adds along each path depend on its length (not counted).
    _work("walk", 4 * bsz * n * n,
          4 * (5 * bsz * n * n + n * n + bsz * n + bsz), "f32")
    if bsz:
        _launch("walk", "walk_launch", dev, nh.data_ptr(), f.data_ptr(),
                delay.data_ptr(), bsz, n, max_hops, hops.data_ptr(),
                dsum.data_ptr(), util.data_ptr(), visits.data_ptr(),
                done.data_ptr(), scratch.data_ptr())
    return hops, dsum, util, visits, done


# -------------------------------------------------------------- NSGA-II
#: Largest workspace (bytes) the selection kernel keeps in shared memory;
#: above it (n > ~400 rows at m = 5) the same kernel works in a global
#: scratch buffer.
NSGA2_SMEM_MAX = 48 * 1024


def nsga2_workspace_words(n: int, m: int) -> int:
    """32-bit words of the selection kernel's workspace: the objectives by
    column, each row's place and each place's row per objective, the
    dominance bits, the ranked rows' bits and the ranks."""
    words = -(-n // 32)
    return 3 * n * m + n * words + words + n


def nsga2_rank(objs: torch.Tensor) -> torch.Tensor:
    """NSGA-II's nondominated rank and crowding distance of the (n, m) f32
    objective rows, as one (2, n) i32 tensor: row 0 the ranks, row 1 the
    crowding distances' f32 bits (``out[1].view(torch.float32)``).

    On the card one launch computes what ``ref.nsga2_rank_ref`` computes,
    the crowding bit for bit; its workspace is in shared memory up to
    :data:`NSGA2_SMEM_MAX` bytes and in a global scratch buffer above."""
    on_card = _on_cuda(objs)
    if objs.dim() != 2 or objs.dtype != torch.float32:
        raise ValueError(f"objs: expected (n, m) f32 rows, got {objs.dtype} "
                         f"{tuple(objs.shape)}")
    if not on_card:
        rank, crowd = ref.nsga2_rank_ref(objs)
        return torch.stack((rank, crowd.view(torch.int32)))
    n, m = objs.shape
    _check(objs, "objs", torch.float32, (n, m))
    dev = objs.device
    out = torch.empty((2, n), dtype=torch.int32, device=dev)
    words = nsga2_workspace_words(n, m)
    scratch = (None if 4 * words <= NSGA2_SMEM_MAX else
               torch.empty(words, dtype=torch.int32, device=dev))
    # Two compares per (row, row, objective) for the dominance and two for
    # the places; the rows read once, rank and crowding written once.
    _work("nsga2_rank", 4 * n * n * m, 4 * n * m + 8 * n, "f32")
    if n:
        _launch("nsga2_rank", "nsga2_rank_launch", dev, objs.data_ptr(), n, m,
                None if scratch is None else scratch.data_ptr(),
                out.data_ptr())
    return out


# ------------------------------------------------------------------- K5
#: Largest head dimension the attention kernel takes (bf16: padded to a
#: multiple of 16 on the tensor cores; f32: 8 columns per lane).
ATTN_MAX_HEAD_DIM = 256
_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _grads_of_plain(ctx, plain, g: torch.Tensor) -> tuple:
    """The gradients of ``plain`` at the inputs saved in ``ctx``, against
    the output gradient ``g``: the plain version recomputed with autograd
    on, for the inputs that need a gradient (None for the others)."""
    saved = ctx.saved_tensors        # unpacked once (remat recomputes it)
    need = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        out = plain(*ins)
        grads = iter(torch.autograd.grad(
            out, [t for t, n in zip(ins, need) if n], g))
    return tuple(next(grads) if n else None for n in need)


class _AttentionFn(torch.autograd.Function):
    """K5 with a gradient: the forward is :func:`_attention` (the kernel on
    the card), the backward recomputes ``ref.attention_ref`` from the saved
    q, k, v (no logits are saved)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window)
        return _attention(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        causal, window = ctx.mask
        return (*_grads_of_plain(
            ctx, lambda q, k, v: ref.attention_ref(q, k, v, causal=causal,
                                                   window=window), g),
            None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None) -> torch.Tensor:
    """GQA attention forward (K5): q (B, H, Sq, D), k/v (B, KH, Sk, D), bf16
    or f32, any strides with a contiguous last dimension, D <= 256. Returns
    (B, H, Sq, D) in q's dtype. ``window`` None means no window.

    On the card the dtype picks the kernel: bf16 runs on the tensor cores
    (bf16 operands, f32 accumulators, probabilities as two bf16 terms
    hi + lo in p.v), f32 on the CUDA cores in f32. Where autograd needs a
    gradient, the call goes through :class:`_AttentionFn`."""
    if _needs_grad(q, k, v):
        return _AttentionFn.apply(q, k, v, causal, window)
    return _attention(q, k, v, causal, window)


@functools.lru_cache(maxsize=256)
def attention_pairs(sq: int, sk: int, causal: bool, window: int | None
                    ) -> int:
    """(query, key) pairs under K5's mask for one head: query i sees key
    j when j <= i (causal) and j > i - window (a window)."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _attention(q, k, v, causal: bool, window: int | None) -> torch.Tensor:
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
    _work("flash_attention",
          4 * d * b * h * attention_pairs(sq, sk, causal, window),
          q.dtype.itemsize * (2 * b * h * sq * d + 2 * b * kh * sk * d),
          dtype_name(q.dtype))
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


def ssd_plain(x, dt, a, b, c, d, *, chunk: int = 64,
              return_state: bool = False):
    """The plain version of what :func:`ssd` computes on x's device. On the
    CPU, the reference's choice: the chunked form when S is a multiple of
    ``chunk`` above it, else the sequential scan. On the card, the kernel's:
    S padded with zero rows to a multiple of ``chunk`` (none when it is
    one), which leave the state unchanged, then the chunked form."""
    if x.device.type != "cpu":
        return ref.ssd_padded_ref(x, dt, a, b, c, d, chunk=chunk,
                                  return_state=return_state)
    s = x.shape[1]
    if s % chunk == 0 and s > chunk:
        return ref.ssd_chunked_ref(x, dt, a, b, c, d, chunk=chunk,
                                   return_state=return_state)
    return ref.ssd_ref(x, dt, a, b, c, d, return_state=return_state)


class _SsdFn(torch.autograd.Function):
    """K6 with a gradient: the forward is :func:`_ssd` (the kernel on the
    card), the backward recomputes :func:`ssd_plain` from the saved inputs
    and differentiates it, to x, dt, a, b, c and d."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d, chunk):
        ctx.save_for_backward(x, dt, a, b, c, d)
        ctx.chunk = chunk
        return _ssd(x, dt, a, b, c, d, chunk, False)

    @staticmethod
    def backward(ctx, g):
        return (*_grads_of_plain(
            ctx, lambda *args: ssd_plain(*args, chunk=ctx.chunk), g), None)


def ssd(x, dt, a, b, c, d, *, chunk: int = 64, return_state: bool = False):
    """Mamba-2 SSD chunked scan (K6): x (B,S,H,P), dt (B,S,H), a (H,), b/c
    (B,S,N), d (H,), all f32. Returns y (B,S,H,P), plus the final state
    (B,H,N,P) with ``return_state``.

    On the card one block runs 3 heads of a batch row (2 at N > 64),
    sharing each chunk's C B^T, with every f32 product as three TF32
    products on the tensor cores. The kernel takes any S: a ragged tail
    runs as a chunk padded with zero rows. On the CPU this runs
    :func:`ssd_plain`. Where autograd needs a gradient, the call goes
    through :class:`_SsdFn`; ``return_state`` is forward-only, as in the
    reference (the serving path)."""
    if _needs_grad(x, dt, a, b, c, d):
        if return_state:
            raise ValueError("ssd: return_state is forward-only")
        return _SsdFn.apply(x, dt, a, b, c, d, chunk)
    return _ssd(x, dt, a, b, c, d, chunk, return_state)


def ssd_work(bsz: int, s: int, h: int, p: int, n: int, chunk: int,
             return_state: bool) -> tuple[int, int]:
    """(FLOPs as 3xTF32, bytes) of one K6 call: per chunk (a ragged tail
    padded to one) the intra-chunk products over the causal (i, j) pairs
    and the chunk-state products, each f32 product three TF32 products;
    each input read once, y (and the final state) written once."""
    tri = chunk * (chunk + 1) // 2
    per_chunk = 2 * tri * (n + p) + 4 * chunk * n * p
    flops = 3 * bsz * h * (-(-s // chunk)) * per_chunk
    n_bytes = 4 * (2 * bsz * s * h * p + bsz * s * h + 2 * bsz * s * n
                   + 2 * h + (bsz * h * n * p if return_state else 0))
    return flops, n_bytes


def _ssd(x, dt, a, b, c, d, chunk: int, return_state: bool):
    if not _on_cuda(x, dt, a, b, c, d):
        return ssd_plain(x, dt, a, b, c, d, chunk=chunk,
                         return_state=return_state)
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
    flops, n_bytes = ssd_work(bsz, s, h, p, n, chunk, return_state)
    _work("ssd", flops, n_bytes, "tf32")
    if bsz and h:
        _launch("ssd", "ssd_launch", x.device, x.data_ptr(), dt.data_ptr(),
                a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                y.data_ptr(), state.data_ptr() if return_state else None,
                bsz, s, h, p, n, chunk)
    return (y, state) if return_state else y
