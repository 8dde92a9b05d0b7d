"""One run of one cell of the port's benchmark.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; both are data files found by name
(``configs/<config>.json`` through the entry's ``file``, and
``traffic/<traffic>.json``), and every metric is read by a file of its
own, ``metrics/<name>.py``, whose ``read(run)`` returns a number or None.
A new cell, mix, configuration or metric is a new file and a new entry;
no file here changes.

A run: set up (import, load the NoC kernels, build the problem, one warm
search at the cell's shapes), then whole passes over the mix's pool of
searches, each search one ``repro_torch.noc.run`` call ending in a device
sync, until ``seconds`` have passed; then the comparison with the plain
reference (:mod:`portbench.checks`) of every front and of a sample of the
evaluator's answers. With ``trace`` the window runs under
``torch.profiler``, the evaluator's calls are timed, and the per-layer
metrics are read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import checks, reference, traffic
from .trace import EVAL_SPAN, SEARCH_SPAN, DeviceTrace

REPO = Path(__file__).resolve().parent.parent
HARNESS_DIR = "portbench"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list      # metric entries reported with --trace 0
    per_layer: list       # metric entries reported with --trace 1


def load_cell(name: str, repo: Path = REPO) -> Cell:
    """The cell ``name`` of ``<repo>/BENCHMARK.json``, with its
    configuration and traffic mix read from their files."""
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = json.loads((repo / files[w["config"]]).read_text())
    mix = traffic.load_mix(w["traffic"], repo / HARNESS_DIR / "traffic")

    def ours(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, int(w["chips"]), config, mix, ours(bench["end_to_end"]),
                ours(bench["per_layer"]))


def load_reader(name: str, repo: Path = REPO):
    """``read`` of ``<repo>/portbench/metrics/<name>.py``."""
    path = repo / HARNESS_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------ the searches
@dataclasses.dataclass
class Call:
    """One call into the evaluator: its method, how many designs, the
    device passes they were cut into, host seconds, and whether its passes
    run the APSP kernel (K1)."""

    method: str
    designs: int
    chunks: tuple
    seconds: float
    apsp: bool


@dataclasses.dataclass
class Search:
    seed: int
    t0: float
    t1: float
    n_evals: int
    calls: list           # [Call], traced runs only

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0


def chunks(n: int, max_batch: int | None) -> tuple:
    """The device passes the evaluator cuts ``n`` designs into."""
    step = max_batch or max(n, 1)
    return tuple(min(step, n - i) for i in range(0, n, step))


#: Evaluator answers (a design and its row) kept a search for the check.
SAMPLE_PER_SEARCH = 8


class WatchedEvaluator:
    """The port's evaluator, watched. A sample of its answers, drawn from
    the seed (reservoir sampling over every design it evaluates), is kept
    for the comparison with the reference; in a traced run each entry call
    is also timed on the host clock and marked as a profiler span. Every
    other attribute is the evaluator's. Each entry call returns host
    arrays, so it ends in a device sync."""

    def __init__(self, ev, rng: np.random.Generator, calls: list | None):
        self._ev = ev
        self._rng = rng
        self._calls = calls          # None: untimed
        self._seen = 0
        self.sample: list = []       # [(perm, adj, row)]

    def _watch(self, method: str, n: int, fn, arg, design_at):
        if self._calls is None:
            out = fn(arg)
        else:
            from torch.profiler import record_function

            apsp = not (method == "batch_moves" and self._ev.delta_on)
            with record_function(EVAL_SPAN + method):
                t0 = time.perf_counter()
                out = fn(arg)
                t1 = time.perf_counter()
            self._calls.append(Call(method, n, chunks(n, self._ev.max_batch),
                                    t1 - t0, apsp))
        if design_at is not None:
            rows = out[0] if method == "batch_aux" else out
            self._keep(n, design_at, np.asarray(rows).reshape(n, -1))
        return out

    def _keep(self, n: int, design_at, rows: np.ndarray) -> None:
        """Algorithm R over the designs of this call."""
        k = SAMPLE_PER_SEARCH
        pos = self._seen + np.arange(n)
        slot = np.where(pos < k, pos, self._rng.integers(0, pos + 1))
        for j in np.flatnonzero(slot < k):
            d = design_at(int(j))
            item = (d.perm.copy(), d.adj.copy(), rows[j].copy())
            if slot[j] < len(self.sample):
                self.sample[slot[j]] = item
            else:
                self.sample.append(item)
        self._seen += n

    def batch(self, designs):
        return self._watch("batch", len(designs), self._ev.batch, designs,
                           designs.__getitem__)

    def batch_aux(self, designs):
        return self._watch("batch_aux", len(designs), self._ev.batch_aux,
                           designs, designs.__getitem__)

    def batch_moves(self, moves):
        ms = moves if isinstance(moves, (list, tuple)) else [moves]
        owner = [(m, i) for m in ms for i in range(len(m))]
        return self._watch("batch_moves", len(owner), self._ev.batch_moves,
                           moves, lambda j: owner[j][0].materialize(
                               owner[j][1]))

    def __call__(self, d):
        return self._watch("__call__", 1, self._ev, d, lambda j: d)

    def edp(self, d):
        return self._watch("edp", 1, self._ev.edp, d, None)

    def __getattr__(self, name):
        return getattr(self._ev, name)


class Program:
    """The system under test, set up for one cell: the port's problem on
    the benchmark's traffic matrix."""

    def __init__(self, cell: Cell, device: str):
        import torch
        from repro_torch.core.problem import SystemSpec
        from repro_torch.noc import Budget, NocProblem, run

        self.torch, self.Budget, self.run = torch, Budget, run
        self.cell, self.device = cell, device
        if device == "cuda":
            from repro_torch.kernels import build

            build.load(build.NOC_SOURCES)
        self.system = reference.System(**cell.config["system"])
        self.f = traffic.matrix(self.system, cell.mix)
        self.problem = NocProblem(spec=SystemSpec(**cell.config["system"]),
                                  traffic=self.f, case=cell.config["case"])

    def sync(self) -> None:
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def search(self, seed: int, traced: bool, draw: np.random.Generator
               ) -> tuple[Search, checks.Output]:
        """One whole search through ``repro_torch.noc.run``, ending in a
        device sync, on a fresh evaluator (the budget counts its
        evaluations) that the benchmark watches; ``draw`` picks the
        answers kept for the check."""
        from torch.profiler import record_function

        mix = self.cell.mix
        calls = [] if traced else None
        with (record_function(SEARCH_SPAN) if traced
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            ev = WatchedEvaluator(self.problem.evaluator(device=self.device),
                                  draw, calls)
            res = self.run(self.problem, mix["optimizer"],
                           self.Budget(max_evals=int(mix["max_evals"]),
                                       seed=seed),
                           dict(mix["config"]), ev=ev, device=self.device)
            self.sync()
            t1 = time.perf_counter()
        n, d, s = self.system.n_tiles, len(res.designs), len(ev.sample)
        out = checks.Output(
            np.array([x.perm for x in res.designs], np.int64).reshape(d, n),
            np.array([x.adj for x in res.designs], bool).reshape(d, n, n),
            np.asarray(res.objs, dtype=np.float64).reshape(d, -1), res.phv(),
            int(res.n_evals),
            np.array([a[0] for a in ev.sample], np.int64).reshape(s, n),
            np.array([a[1] for a in ev.sample], bool).reshape(s, n, n),
            np.array([a[2] for a in ev.sample], np.float64).reshape(s, -1))
        return Search(seed, t0, t1, int(res.n_evals), calls or []), out

    def window(self, seed: int, seconds: float, traced: bool
               ) -> tuple[list, list]:
        """Whole passes over the mix's pool of searches, each pass in an
        order drawn from ``seed``, until ``seconds`` have passed since the
        first search started and the pass is complete."""
        seeds = traffic.pool(self.cell.mix)
        draw = np.random.default_rng([seed % (1 << 63), 1])
        searches, outputs = [], []
        w0 = time.perf_counter()
        n_pass = 0
        while n_pass == 0 or time.perf_counter() - w0 < seconds:
            for j in traffic.order(seed, n_pass, len(seeds)):
                s, out = self.search(seeds[j], traced, draw)
                searches.append(s)
                outputs.append(out)
            n_pass += 1
        return searches, outputs

    def warm(self, seed: int, traced: bool) -> None:
        """One search at the cell's shapes, its seed drawn from ``seed``."""
        self.search(traffic.search_seed(seed, 0), traced,
                    np.random.default_rng(0))


def budget_limit(mix: dict) -> int:
    """The evaluations a search of ``mix`` stays below."""
    return int(mix["max_evals"]) + int(mix["max_call"])


# -------------------------------------------------------------- one run
@dataclasses.dataclass
class RunData:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    searches: list            # [Search]
    verdict: checks.Verdict
    device_name: str
    n_tiles: int
    device_trace: DeviceTrace | None

    @property
    def window_s(self) -> float:
        """From the start of the first search to the end of the last."""
        return self.searches[-1].t1 - self.searches[0].t0


def _note(text: str) -> None:
    print(f"portbench: {text}", file=sys.stderr, flush=True)


def _profiler(torch):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _warm_profiler(torch, device: str) -> None:
    """One throwaway session: a process's first sets up the tracer while
    it runs and can miss records."""
    x = torch.zeros(1024, device=device)
    with _profiler(torch):
        for _ in range(10):
            x.add_(1.0)
        if device == "cuda":
            torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             repo: Path = REPO) -> dict:
    """One run of ``cell``; returns the result line's object. ``t_start``
    is the process's start on the host clock (default: now)."""
    t_start = time.perf_counter() if t_start is None else t_start
    prog = Program(cell, device)
    torch = prog.torch
    prog.warm(seed, trace)
    if trace:
        _warm_profiler(torch, device)
    gc.collect()

    with (_profiler(torch) if trace else contextlib.nullcontext()) as prof:
        setup_s = time.perf_counter() - t_start
        searches, outputs = prog.window(seed, seconds, trace)
    on_card = device == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    window_s = searches[-1].t1 - searches[0].t0
    _note(f"set-up {setup_s:.3f} s; window {window_s:.3f} s, "
          f"{len(searches)} searches")
    t0 = time.perf_counter()
    dev_trace = DeviceTrace.from_profiler(prof) if trace else None
    if trace:
        _note(f"trace read in {time.perf_counter() - t0:.3f} s: "
              f"{len(dev_trace.ops)} device operations")
    del prof, prog.problem
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    verdict = checks.judge(prog.system, prog.f, cell.config["obj_idx"],
                           budget_limit(cell.mix), outputs)
    _note(f"judged in {time.perf_counter() - t0:.3f} s")
    data = RunData(cell, setup_s, searches, verdict,
                   torch.cuda.get_device_name(0) if on_card else device,
                   prog.system.n_tiles, dev_trace)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"], repo)(data)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device,
           "kind": data.device_name, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    out = {"correct": verdict.correct, "attempted": len(searches),
           "failed": verdict.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = dev_trace.busy_s
        dev["window_s"] = dev_trace.window_s
        out["breakdown"] = dev_trace.breakdown()
    out["checks"] = verdict.checks
    return out
