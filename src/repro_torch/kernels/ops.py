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
)}

_SIGS = {
    "minplus_launch": ("minplus", [_P, _P, _P, _I, _I, _P]),
    "forest_predict_launch": ("forest", [_P] * 6 + [_I] * 5 + [_P]),
    "score_block_max_launch": ("forest", [_P] * 7 + [_I] * 6 + [_P] * 5),
    "forest_blocks": ("forest", [_I]),
    "walk_launch": ("walk", [_P] * 3 + [_I] * 3 + [_P] * 6),
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


def apsp(cost: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Batched APSP by ``n_iters`` min-plus squarings (K1), out of place
    between two buffers."""
    if not _on_cuda(cost):
        return ref.apsp_ref(cost, n_iters)
    _check_square_batch(cost)
    if n_iters == 0:
        return cost.clone()
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
    (B, N, N) f32 and wire delay (N, N) f32."""
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
    if bsz:
        _launch("walk", "walk_launch", dev, nh.data_ptr(), f.data_ptr(),
                delay.data_ptr(), bsz, n, max_hops, hops.data_ptr(),
                dsum.data_ptr(), util.data_ptr(), visits.data_ptr(),
                done.data_ptr())
    return hops, dsum, util, visits, done
