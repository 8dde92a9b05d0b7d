"""The evaluator's device pass on one card, captured once per chunk shape
into a CUDA graph and replayed.

One chunk's pass (cost build → APSP (K1) → next hops → walk (K4) →
objectives, or with host tables the walk and objectives alone) is some
120 small launches, each a few microseconds of host time for well under
that of device time. ``Evaluator._run`` captures the pass into a
``torch.cuda.CUDAGraph`` and replays it: one launch a chunk. The capture
records the very kernels, launch configurations and reduction orders the
eager pass runs, so a replay's rows are the eager pass's bits.

How passes are kept (:class:`PassCache`, one per thread):

- the key is (consts, device, chunk rows, tables given or not);
- a key's first chunk runs eagerly, and warms the pass up; its second is
  captured, and it and every later one replay; a shape seen once never
  costs a capture;
- beyond :data:`CACHE_BYTES` of graph memory and static buffers the
  least recently used pass goes, and its key's next chunk captures again;
- a :class:`Pass` owns what its graph reads and writes: one static input
  buffer (placements, adjacencies and, given, tables) that one copy from
  pinned staging fills, a static traffic matrix, refreshed from the
  evaluator's where another evaluator replays the pass, and one static
  (rows, :data:`OUT_COLS`) output (the objectives, connected, net_lat)
  that one copy reads back; it holds the consts, which ``make_consts``
  may drop, so a graph never points at memory that could be freed.

A capture's kernel launches and work go to the pass's
:class:`repro_torch.kernels.ops.Record`, and every replay adds them to
``ops.KERNELS`` and the work log, so a replayed chunk counts as an eager
one does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
from collections import OrderedDict

import torch

from ..kernels import ops
from .objectives import N_OBJ, SpecConsts

#: Bytes of captured passes one thread keeps: a pass holds its peak
#: transient in its graph's memory pool, mostly the (rows, N, N, N)
#: next-hop broadcast. On an H100 a dense pass of 48 designs at N = 64
#: took 86 MB, of 8 at N = 256 563 MB, one of 8 with tables at N = 256
#: 51 MB; 2 GiB keeps every shape of the benchmark's cells at once.
CACHE_BYTES = 2 << 30

#: Columns of a pass's output: the objectives, connected (1.0 or 0.0) and
#: net_lat.
OUT_COLS = N_OBJ + 2

#: Byte alignment of each field of the static input buffer.
_ALIGN = 256


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a chunk's fields lie in one byte buffer: (name, dtype, shape,
    offset) each, and the buffer's size."""

    fields: tuple
    nbytes: int

    def views(self, buf: torch.Tensor) -> dict:
        """The fields as typed views of the byte tensor ``buf``."""
        return {name: buf[off:off + math.prod(shape) * dt.itemsize]
                .view(dt).view(shape)
                for name, dt, shape, off in self.fields}


@functools.lru_cache(maxsize=256)
def layout(rows: int, n: int, tables: bool) -> Layout:
    """A chunk's static input: placements (rows, n) int64 and adjacencies
    (rows, n, n) bool, with ``tables`` distances f32 and next hops i32."""
    fields, off = [], 0
    spec = [("perm", torch.int64, (rows, n)),
            ("adj", torch.bool, (rows, n, n))]
    if tables:
        spec += [("dist", torch.float32, (rows, n, n)),
                 ("nh", torch.int32, (rows, n, n))]
    for name, dt, shape in spec:
        fields.append((name, dt, shape, off))
        off += -(-math.prod(shape) * dt.itemsize // _ALIGN) * _ALIGN
    return Layout(tuple(fields), off)


@dataclasses.dataclass(eq=False)
class Pass:
    """One chunk shape's device pass and every tensor it reads or writes.

    Built for a chunk run eagerly too, then without a graph: ``f`` is the
    evaluator's own matrix there and nothing is kept."""

    inputs: torch.Tensor      # uint8 static input buffer, :func:`layout`
    views: dict               # its typed fields
    f: torch.Tensor           # traffic matrix the pass reads
    out: torch.Tensor         # (rows, OUT_COLS) f32
    consts: SpecConsts
    f_src: torch.Tensor | None = None   # the evaluator matrix ``f`` holds
    graph: object = None
    record: ops.Record | None = None
    nbytes: int = 0

    @classmethod
    def new(cls, lay: Layout, consts: SpecConsts, f: torch.Tensor,
            device: torch.device, *, static: bool) -> "Pass":
        """Fresh buffers for a chunk of ``lay``; ``static`` (to capture)
        gives the pass its own copy of ``f``."""
        inputs = torch.empty(lay.nbytes, dtype=torch.uint8, device=device)
        rows = lay.fields[0][2][0]
        out = torch.empty((rows, OUT_COLS), dtype=torch.float32,
                          device=device)
        return cls(inputs, lay.views(inputs), f.clone() if static else f,
                   out, consts, f if static else None)

    def use_f(self, f: torch.Tensor) -> None:
        """Make the static traffic matrix ``f``'s values, on the stream,
        where it last held another evaluator's."""
        if self.f_src is not f:
            self.f.copy_(f, non_blocking=True)
            self.f_src = f


class PassCache:
    """Captured passes by key, least recently used first out beyond
    ``max_bytes``; the keys seen so far."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self.passes: OrderedDict = OrderedDict()
        self.seen: set = set()
        self.nbytes = 0

    def find(self, key) -> tuple[Pass | None, bool]:
        """(the captured pass of ``key``, None where there is none; whether
        to capture one): a key's first sighting runs eagerly, a later one
        without a pass captures."""
        p = self.passes.get(key)
        if p is not None:
            self.passes.move_to_end(key)
            return p, False
        if key in self.seen:
            return None, True
        self.seen.add(key)
        return None, False

    def add(self, key, p: Pass) -> None:
        """Keep the captured ``p``; drop the least recently used others
        while the bytes exceed the bound."""
        self.passes[key] = p
        self.nbytes += p.nbytes
        while self.nbytes > self.max_bytes and len(self.passes) > 1:
            _, old = self.passes.popitem(last=False)
            self.nbytes -= old.nbytes


class _Thread(threading.local):
    def __init__(self):
        self.cache = PassCache(CACHE_BYTES)
        self.staging: dict = {}     # "in" / "out" -> host byte buffer
        self.streams: dict = {}     # device -> capture stream


_thread = _Thread()

#: One capture at a time in the process (a CUDA graph's capture rule).
_capture_lock = threading.Lock()


def cache() -> PassCache:
    """This thread's passes."""
    return _thread.cache


def serves(device: torch.device) -> bool:
    """Whether a single-device evaluator on ``device`` replays graphs: on a
    CUDA device. The CPU keeps its eager host order."""
    return device.type == "cuda"


def staging(which: str, nbytes: int, device: torch.device) -> torch.Tensor:
    """This thread's host byte buffer ``which`` ("in" or "out"), its first
    ``nbytes``; pinned for a CUDA ``device``, so that its copies run
    asynchronously. A chunk's read waits for its copies, so the next chunk
    may write it."""
    buf = _thread.staging.get(which)
    if buf is None or buf.numel() < nbytes:
        size = max(nbytes, 2 * (0 if buf is None else buf.numel()), 1 << 16)
        buf = _thread.staging[which] = torch.empty(
            size, dtype=torch.uint8, pin_memory=device.type == "cuda")
    return buf[:nbytes]


def capture(fn, device: torch.device) -> tuple[object, int]:
    """A CUDA graph of what ``fn()`` enqueues on ``device``, captured on
    this thread's side stream after the current stream's work, and the
    bytes its memory pool took. Only this thread is barred from unsafe
    calls meanwhile; other threads keep running."""
    streams = _thread.streams
    side = streams.get(device)
    if side is None:
        side = streams[device] = torch.cuda.Stream(device)
    cur = torch.cuda.current_stream(device)
    g = torch.cuda.CUDAGraph()
    with _capture_lock:
        before = torch.cuda.memory_reserved(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            g.capture_begin(capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                try:
                    g.capture_end()
                except RuntimeError:
                    pass
                raise
            g.capture_end()
        cur.wait_stream(side)
        grown = torch.cuda.memory_reserved(device) - before
    return g, max(0, grown)


def captured(p: Pass, fn, device: torch.device) -> Pass:
    """``p`` with the graph of ``fn`` (its pass), the launches and work
    its capture enqueued, and its bytes."""
    with ops.recorded() as rec:
        p.graph, pool = capture(fn, device)
    p.record = rec
    p.nbytes = pool + sum(t.numel() * t.element_size()
                          for t in (p.inputs, p.f, p.out))
    return p


def replay(p: Pass) -> None:
    """Run ``p``'s graph on the current stream and count its launches."""
    p.graph.replay()
    ops.replayed(p.record)


def wait(device: torch.device) -> None:
    """Wait for the current stream's work on ``device``."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
