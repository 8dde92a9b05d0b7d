"""Pod dry run on the meta device: the counterpart of the reference's
``repro.launch.dryrun``, which lowers and compiles one device's program
of a TPU pod against ``ShapeDtypeStruct``s and reads XLA's analyses.

Here rank 0's program of the same mesh runs eagerly on the ``"meta"``
device (shapes and dtypes, no data, no allocation) under a
:class:`Counter`, a ``TorchDispatchMode`` that sees every aten op:

* GEMM and convolution FLOPs, from ``torch.utils.flop_counter``'s
  registry, keyed by the dtype of the op's first input;
* bytes, Σ (inputs + outputs) of every op that is not a view or a bare
  allocation (the eager port fuses nothing, so this is what it moves);
* the live storage bytes and their peak, one count per storage (views
  count once), freed when the storage dies;
* the op log, the hand kernels' work (``kernels.ops.work_log``: K5 with
  its mask, K6 in its chunked form) and every collective as it is issued
  (``launch.hlo.CollectiveLog``).

The mesh is abstract (``launch.mesh.Mesh`` with names and sizes, no
process groups): a collective records and returns a meta tensor of its
result's shape (``dist.collectives``). Rank 0's program stands for every
rank. Ranks differ where a rank's coordinates pick its shard (the same
shapes on every rank) and in one place where the work differs: MoE over
a data axis routes each rank's own tokens only when they form whole
1024-token groups, else every data rank gathers and routes the whole
batch (``models.parallel.ShardPlan.moe_tokens``).

For every (architecture x input shape) cell on both pod meshes,

    single-pod  (16, 16)      axes (data, model)          256 cards
    multi-pod   (2, 16, 16)   axes (pod, data, model)     512 cards

the step (the train step for train shapes, prefill or decode otherwise)
runs once and its record goes to ``experiments/h100/dryrun/<cell>.json``
with the reference's fields: FLOPs and bytes per card, memory (argument
bytes: the rank's parameter shards with the serving model's compute-dtype
copies, optimizer state and its rows of the inputs; temp bytes: the peak
of the live bytes the step allocated; whether both fit the card's HBM),
the collective schedule and its wire bytes, by kind and by mesh axis,
and the kernels' records. ``trace_s`` and ``n_ops`` stand in for the
reference's compile times and HLO size. The trace needs no card; the
card's peaks (``launch.constants``) come from the card present or from
``--card``. Usage:

    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \\
        --card "NVIDIA H100 80GB HBM3"
    python -m repro_torch.launch.dryrun --all [--multi-pod-only|
        --single-pod-only] [--card NAME] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import (ARCH_NAMES, SHAPES, applicable, cell_status,
                       get_config, input_specs)
from ..dist import sharding as shd
from ..kernels import ops as kops
from ..models.model import build, build_train
from ..train.optimizer import OptConfig
from ..train.train_step import make_decode_fn, make_prefill_fn, make_train_fns
from . import hlo
from .constants import Peaks, peaks
from .mesh import make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "h100", "dryrun")

_aten = torch.ops.aten
#: Ops that allocate and write nothing: no traffic.
_ALLOCATIONS = {_aten.empty.memory_format, _aten.empty_strided.default,
                _aten.empty_like.default, _aten.new_empty.default,
                _aten.new_empty_strided.default}


def _tensors(obj, out: list) -> list:
    """Append the tensors of ``obj`` (nested lists, tuples and dicts)."""
    if isinstance(obj, dict):
        obj = obj.values()
    elif isinstance(obj, torch.Tensor):
        out.append(obj)
        return out
    elif not isinstance(obj, (list, tuple)):
        return out
    for o in obj:
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, (list, tuple, dict)):
            _tensors(o, out)
    return out


_PLAIN = (bool, int, float, str, torch.dtype, torch.device, torch.layout,
          torch.memory_format, type(None))


def _arg_key(a):
    """A hashable key of an op argument's metadata; raises TypeError on
    an argument it cannot key."""
    if isinstance(a, torch.Tensor):
        if not a.is_meta:
            raise TypeError("not meta")
        return (a.shape, a.stride(), a.dtype)
    if isinstance(a, (list, tuple)):
        return tuple(_arg_key(x) for x in a)
    if isinstance(a, _PLAIN):
        return a
    raise TypeError(type(a))


def _meta_key(func, args, kwargs):
    """The cache key of a call on the meta device, or None (another
    device, or an argument it cannot key)."""
    dev = kwargs.get("device")
    if not (_has_tensor(args) or (dev is not None
                                  and torch.device(dev).type == "meta")):
        return None
    try:
        return (func, _arg_key(args),
                tuple((k, _arg_key(v)) for k, v in sorted(kwargs.items())))
    except TypeError:
        return None


def _has_tensor(args) -> bool:
    return any(isinstance(a, torch.Tensor) or (isinstance(a, (list, tuple))
                                               and _has_tensor(a))
               for a in args)


def _aliases_input(args, kwargs, out) -> bool:
    """Whether an output shares a storage with an input (``_unsafe_view``
    does, unannounced by its schema)."""
    ins = {t.untyped_storage()._cdata
           for t in _tensors(kwargs, _tensors(args, []))}
    return any(t.untyped_storage()._cdata in ins for t in _tensors(out, []))


def _spec(out):
    """("one", (shape, stride, dtype)) of an output tensor, ("many",
    [...]) of a tuple of them, or None for other outputs."""
    def one(t):
        return (tuple(t.shape), t.stride(), t.dtype)

    if isinstance(out, torch.Tensor):
        return ("one", one(out))
    if isinstance(out, tuple) and out and all(
            isinstance(o, torch.Tensor) for o in out):
        return ("many", [one(o) for o in out])
    return None


def _from_spec(spec):
    def one(s):
        return torch.empty_strided(s[0], s[1], dtype=s[2], device="meta")

    kind, body = spec
    return one(body) if kind == "one" else tuple(one(s) for s in body)


class Counter(TorchDispatchMode):
    """Counts the aten ops run inside ``with Counter() as c:`` on any
    device (see the module docstring): ``ops`` (names in order),
    ``flops`` ({dtype: GEMM/conv FLOPs}), ``bytes``, ``peak`` and
    ``live`` (bytes of the storages the ops allocated), ``kernels``
    (``kernels.ops.Work`` records) and ``collectives`` (a
    ``launch.hlo.CollectiveLog``)."""

    def __init__(self):
        super().__init__()
        self.ops: list = []
        self.flops: dict = {}
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.kernels: list = []
        self.collectives = hlo.CollectiveLog()
        self._storages: dict = {}
        self._info: dict = {}
        self._leaves: set = set()
        self._aliasing: set = set()
        self._meta: dict = {}
        self._work = None

    def __enter__(self):
        self.collectives.__enter__()
        self._work = kops.work_log(self.kernels)
        self._work.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._work.__exit__(*exc)
            self.collectives.__exit__(*exc)
            # Dropping the weak references drops their callbacks.
            self._storages.clear()

    def _op(self, func):
        """(name, returns an alias, allocates only, FLOP formula, may be
        replayed from the meta cache) of ``func``."""
        info = self._info.get(func)
        if info is None:
            aliases = func.is_view or any(
                r.alias_info is not None for r in func._schema.returns)
            info = (str(func), aliases, func in _ALLOCATIONS,
                    flop_registry.get(func.overloadpacket),
                    not aliases and not func._schema.is_mutable)
            self._info[func] = info
        return info

    def _decompose(self, func, args, kwargs):
        """The op's composite decomposition run under this mode (its ops
        come back here), or NotImplemented."""
        if func in self._leaves:
            return NotImplemented
        TorchDispatchMode.__enter__(self)
        try:
            out = func.decompose(*args, **kwargs)
        finally:
            TorchDispatchMode.__exit__(self, None, None, None)
        if out is NotImplemented:
            self._leaves.add(func)
        return out

    def _run(self, func, args, kwargs, pure: bool):
        """``func`` on its inputs; on meta inputs a pure op's outputs are
        made from the metadata its first run on the same input metadata
        gave (Python meta kernels cost ~0.3 ms an op; the layers repeat)."""
        key = (_meta_key(func, args, kwargs)
               if pure and func not in self._aliasing else None)
        if key is not None:
            spec = self._meta.get(key)
            if spec is not None:
                return _from_spec(spec)
        out = func(*args, **kwargs)
        if key is not None:
            if _aliases_input(args, kwargs, out):
                self._aliasing.add(func)
            else:
                spec = _spec(out)
                if spec is not None:
                    self._meta[key] = spec
        return out

    def _free(self, key, nbytes) -> None:
        self.live -= nbytes
        self._storages.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # Under inference mode composite ops (matmul, reshape, to) reach
        # the mode whole: run their decomposition, whose ops come back
        # here, so every mode counts the same leaf ops.
        out = self._decompose(func, args, kwargs)
        if out is not NotImplemented:
            return out
        name, aliases, alloc, flop_fn, pure = self._op(func)
        out = self._run(func, args, kwargs, pure)
        self.ops.append(name)
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        if flop_fn is not None:
            key = kops.dtype_name(ins[0].dtype)
            self.flops[key] = self.flops.get(key, 0) + flop_fn(
                *args, **kwargs, out_val=out)
        if not func.is_view and not alloc:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        if not aliases:
            in_keys = None
            for t in outs:
                st = t.untyped_storage()
                key = st._cdata
                if key in self._storages:
                    continue
                if in_keys is None:
                    in_keys = {i.untyped_storage()._cdata for i in ins}
                if key in in_keys:      # an alias its schema does not name
                    continue
                nbytes = st.nbytes()
                self.live += nbytes
                self.peak = max(self.peak, self.live)
                self._storages[key] = weakref.ref(
                    st, lambda _, k=key, n=nbytes: self._free(k, n))
        return out

    # ----------------------------------------------------------- summaries
    def kernel_summary(self) -> dict:
        """{kernel: {"calls", "flops", "bytes", "dtype"}}."""
        out: dict = {}
        for w in self.kernels:
            k = out.setdefault(w.kernel, {"calls": 0, "flops": 0.0,
                                          "bytes": 0.0, "dtype": w.dtype})
            k["calls"] += 1
            k["flops"] += w.flops
            k["bytes"] += w.bytes
        return out

    def flops_by_dtype(self) -> dict:
        """GEMM/conv FLOPs and the kernels' FLOPs, by dtype."""
        out = {k: float(v) for k, v in self.flops.items()}
        for w in self.kernels:
            out[w.dtype] = out.get(w.dtype, 0.0) + w.flops
        return out

    def total_bytes(self) -> float:
        """The ops' bytes and the kernels' bytes."""
        return float(self.bytes) + sum(w.bytes for w in self.kernels)

    def op_counts(self) -> dict:
        counts: dict = {}
        for o in self.ops:
            counts[o] = counts.get(o, 0) + 1
        return counts


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen, total = set(), 0
    for t in _tensors(tree, []):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def _local(mesh, specs: dict, tree: dict) -> dict:
    """Meta tensors of this rank's shard shapes of a whole tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _local(mesh, specs[k], v)
        elif isinstance(v, torch.Tensor):
            shape = shd.local_shape(mesh, specs[k], tuple(v.shape))
            out[k] = torch.empty(shape, dtype=v.dtype, device="meta")
        else:
            out[k] = v
    return out


def _rows_bytes(mesh, policy, batch: dict) -> int:
    """Bytes of this rank's rows of a whole batch (split along dim 0 over
    the batch axes, as ``ShardPlan.batch_local`` splits it)."""
    total = 0
    for v in _tensors(batch, []):
        axes = shd._fit(mesh, v.shape[0], policy.axes_for("batch"), set())
        n = shd.shard_index(mesh, axes)[1]
        total += v.numel() // n * v.element_size()
    return total


def build_traced(arch: str, shape_name: str, mesh, policy: shd.Policy,
                 cfg_overrides: dict | None = None):
    """Run the cell's step for the rank at ``mesh.coords`` (rank 0 on a
    pod mesh) on meta inputs from ``input_specs``, under a
    :class:`Counter`. Returns (the counter, {"params", "model", "state",
    "inputs"}: the rank's argument bytes, cfg): "params" the parameter
    shards (the reference's), "model" with the serving model's
    compute-dtype copies."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.scaled(**cfg_overrides)
    shape = SHAPES[shape_name]
    specs = input_specs(cfg, shape)

    if shape.kind == "train":
        model = build_train(cfg, "meta", mesh=mesh, policy=policy)
        init_state, step = make_train_fns(model, mesh, policy, OptConfig())
        state = init_state(0, "meta")
        p = tree_bytes(state["params"])
        args = {"params": p, "model": p,
                "state": tree_bytes({k: v for k, v in state.items()
                                     if k != "params"}),
                "inputs": _rows_bytes(mesh, policy, specs)}
        with Counter() as c:
            step(state, specs)
        return c, args, cfg

    model = build(cfg, device="meta", mesh=mesh, policy=policy)
    args = {"params": tree_bytes(model.params),
            "model": tree_bytes([model.params, model.run_params]),
            "state": 0}
    if shape.kind == "prefill":
        fn = make_prefill_fn(model, mesh, policy)
        args["inputs"] = _rows_bytes(mesh, policy, specs)
        with Counter() as c:
            fn(specs)
        return c, args, cfg

    cache = _local(mesh, shd.cache_specs(mesh, policy, cfg, specs["cache"]),
                   specs["cache"])
    fn = make_decode_fn(model, mesh, policy)
    args["inputs"] = (tree_bytes(cache)
                      + _rows_bytes(mesh, policy, {"t": specs["token"]}))
    with Counter() as c:
        fn(cache, specs["token"])
    return c, args, cfg


def card_peaks(card: str | Peaks | None = None) -> Peaks:
    """The peaks of ``card`` (a name or a Peaks), else of the card
    present; raises with neither."""
    if isinstance(card, Peaks):
        return card
    if card is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no card present: name one (--card, e.g. "
                               "\"NVIDIA H100 80GB HBM3\")")
        card = torch.cuda.get_device_name(0)
    return peaks(card)


def trace_record(counter: Counter, args: dict, card: Peaks) -> dict:
    """The reference's measured fields of a traced cell."""
    by_axis: dict = {}
    for r in counter.collectives.records:
        by_axis.setdefault(r.axis, []).append(r)
    coll = hlo.parse_collectives(counter.collectives)
    arg_bytes = args["model"] + args["state"] + args["inputs"]
    return {
        "flops": sum(counter.flops_by_dtype().values()),
        "flops_by_dtype": counter.flops_by_dtype(),
        "bytes_accessed": counter.total_bytes(),
        "memory": {
            "argument_size_in_bytes": int(arg_bytes),
            "temp_size_in_bytes": int(counter.peak),
            "parameter_size_in_bytes": int(args["params"]),
            "fits": bool(arg_bytes + counter.peak <= card.hbm_bytes),
        },
        "collectives": coll,
        "collectives_by_axis": {a: hlo.parse_collectives(rs)
                                for a, rs in sorted(by_axis.items())},
        "wire_bytes": hlo.wire_bytes(coll),
        "kernels": counter.kernel_summary(),
        "n_ops": len(counter.ops),
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             policy: shd.Policy | None = None,
             cfg_overrides: dict | None = None, card=None,
             save: bool = True, out_dir: str | None = None) -> dict:
    card = card_peaks(card)
    policy = policy or shd.default_policy_for(SHAPES[shape_name].kind)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "card": card.name, "status": cell_status(arch, shape_name)}
    if not applicable(arch, shape_name):
        if save:
            _save(rec, out_dir)
        return rec
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.perf_counter()
        counter, args, _ = build_traced(arch, shape_name, mesh, policy,
                                        cfg_overrides)
        t1 = time.perf_counter()
        rec.update(status="ok", trace_s=round(t1 - t0, 2),
                   **trace_record(counter, args, card),
                   n_devices=mesh.size)
    except Exception as e:
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    if save:
        _save(rec, out_dir)
    return rec


def _save(rec: dict, out_dir: str | None = None):
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as fh:
        json.dump(rec, fh, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--card", default=None,
                    help="the card's name as nvidia-smi prints it (default: "
                         "the card present)")
    ap.add_argument("--out", default=None, help=f"default {OUT_DIR}")
    args = ap.parse_args(argv)
    card = card_peaks(args.card)

    meshes = [False, True]
    if args.multi_pod_only:
        meshes = [True]
    if args.single_pod_only:
        meshes = [False]

    cells: list[tuple[str, str]]
    if args.all:
        cells = [(a, s) for a in ARCH_NAMES for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    n_fail = 0
    t0 = time.perf_counter()
    for arch, shape_name in cells:
        for mp in meshes:
            rec = run_cell(arch, shape_name, multi_pod=mp, card=card,
                           out_dir=args.out)
            tag = "MULTI " if mp else "single"
            if rec["status"] == "ok":
                mem = rec["memory"]
                print(f"[{tag}] {arch:22s} {shape_name:12s} OK   "
                      f"trace {rec['trace_s']:6.1f}s ops {rec['n_ops']:8d}  "
                      f"flops/dev {rec['flops']:.3e}  "
                      f"bytes/dev {(mem['argument_size_in_bytes'] + mem['temp_size_in_bytes']) / 1e9:7.2f} GB"
                      f"{'' if mem['fits'] else ' (does not fit)'}  "
                      f"wire {rec['wire_bytes'] / 1e9:8.3f} GB", flush=True)
            elif rec["status"].startswith("skip"):
                print(f"[{tag}] {arch:22s} {shape_name:12s} SKIP "
                      f"({rec['status']})", flush=True)
            else:
                n_fail += 1
                print(f"[{tag}] {arch:22s} {shape_name:12s} FAIL "
                      f"{rec['error']}", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")
    print(f"dry-run complete: all cells traced on {card.name} "
          f"({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
