"""The evaluator's graph path (``repro_torch.core.graphs``) on the CPU, with
a stand-in for a CUDA graph: its capture keeps the pass's function, its
replay calls it. So the policy runs as on the card: the key, capture on a
shape's second sighting, one-off shapes eager, least recently used passes
dropped at the byte bound, one cache per thread, a pass holding what its
graph reads, and the traffic matrix a static input refreshed from the
evaluator's rather than baked in. Rows through the stand-in are the eager
CPU path's bits. Also: launches and work made while capturing count at
each replay, and the benchmark's ``graph_replay_share`` readers."""

import gc
import threading
import types
import weakref

import numpy as np
import pytest
import torch

from portbench import harness
from repro_torch import tracing
from repro_torch.core import graphs
from repro_torch.core.evaluate import Evaluator
from repro_torch.core.objectives import make_consts
from repro_torch.core.problem import (random_design, sample_neighbor_moves,
                                      spec_16, spec_tiny)
from repro_torch.core.traffic import traffic_matrix
from repro_torch.kernels import ops


class _StandIn:
    """A graph that replays by calling the captured pass's function."""

    def __init__(self, fn):
        self.fn = fn
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.fn()


@pytest.fixture
def card(monkeypatch):
    """The graph path for CPU evaluators made inside the test, with a fresh
    cache for this thread; returns the stand-ins captured."""
    captured = []

    def capture(fn, device):
        captured.append(_StandIn(fn))
        return captured[-1], 1000

    monkeypatch.setattr(graphs, "serves", lambda device: True)
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs._thread, "cache",
                        graphs.PassCache(graphs.CACHE_BYTES))
    return captured


def _designs(spec, n, seed):
    rng = np.random.default_rng(seed)
    return [random_design(spec, rng) for _ in range(n)]


def _plain(spec, f, designs, **kw):
    """The eager CPU path's rows, whatever ``graphs.serves`` says."""
    ev = Evaluator(spec, f, device="cpu", **kw)
    ev._graphs = False
    return ev.batch_aux(designs)


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    for k in want[1]:
        assert got[1][k].dtype == want[1][k].dtype, k
        np.testing.assert_array_equal(got[1][k], want[1][k])


def test_cpu_and_split_evaluators_stay_eager(monkeypatch):
    spec = spec_tiny()
    f = traffic_matrix(spec, "BFS")
    assert not Evaluator(spec, f, device="cpu")._graphs
    monkeypatch.setattr(graphs, "serves", lambda device: True)
    assert Evaluator(spec, f, device="cpu")._graphs
    assert not Evaluator(spec, f, device="cpu",
                         split_devices=["cpu", "cpu"])._graphs


def test_second_sighting_captures_and_rows_stay_the_eager_bits(card):
    spec = spec_16()
    f = traffic_matrix(spec, "BFS")
    ev = Evaluator(spec, f, device="cpu")
    cache = graphs.cache()
    for i in range(4):
        designs = _designs(spec, 6, i)
        _same(ev.batch_aux(designs), _plain(spec, f, designs))
        assert len(card) == (0 if i == 0 else 1)
        assert len(cache.passes) == (0 if i == 0 else 1)
    # Captured on the second call, which replays too; the later two replay.
    assert card[0].replays == 3
    assert ev.n_calls == 4 and ev.n_evals == 24


def test_one_off_shapes_stay_eager(card):
    spec = spec_16()
    f = traffic_matrix(spec, "BFS")
    ev = Evaluator(spec, f, device="cpu")
    for rows in (1, 2, 3, 5):
        designs = _designs(spec, rows, rows)
        _same(ev.batch_aux(designs), _plain(spec, f, designs))
    assert card == [] and not graphs.cache().passes
    assert len(graphs.cache().seen) == 4


def test_chunks_of_one_call_share_a_key(card):
    """A call of 10 rows at max_batch 4 is chunks of 4, 4, 2: the second
    chunk of 4 already captures."""
    spec = spec_16()
    f = traffic_matrix(spec, "BFS")
    designs = _designs(spec, 10, 7)
    ev = Evaluator(spec, f, device="cpu", max_batch=4)
    _same(ev.batch_aux(designs), _plain(spec, f, designs, max_batch=4))
    assert len(card) == 1 and card[0].replays == 1 and ev.n_calls == 3


def test_the_key_is_consts_device_rows_and_tables(card):
    spec = spec_16()
    f = traffic_matrix(spec, "BFS")
    ev = Evaluator(spec, f, device="cpu", delta="on")
    rng = np.random.default_rng(3)
    base = random_design(spec, rng)
    moves = sample_neighbor_moves(spec, base, rng, 3, 3)
    plain = Evaluator(spec, f, device="cpu", delta="off")
    plain._graphs = False
    want = plain.batch_moves(moves)
    designs = [moves.materialize(j) for j in range(len(moves))]
    for _ in range(2):
        np.testing.assert_array_equal(ev.batch_moves(moves), want)
        np.testing.assert_array_equal(ev.batch(designs), want)
    other = spec_tiny()
    ev2 = Evaluator(other, traffic_matrix(other, "BFS"), device="cpu")
    for _ in range(2):
        ev2.batch(_designs(other, len(moves), 1))
    keys = set(graphs.cache().passes)
    n = len(moves)
    dev = torch.device("cpu")
    assert keys == {(id(ev.consts), dev, n, True),
                    (id(ev.consts), dev, n, False),
                    (id(ev2.consts), dev, n, False)}
    assert {tuple(sorted(p.views)) for p in graphs.cache().passes.values()
            } == {("adj", "dist", "nh", "perm"), ("adj", "perm")}


def test_least_recently_used_passes_go_at_the_byte_bound(card):
    spec = spec_16()
    f = traffic_matrix(spec, "BFS")
    ev = Evaluator(spec, f, device="cpu")
    size = {}
    for rows in (1, 2, 3):
        for _ in range(2):
            ev.batch(_designs(spec, rows, 0))
        size[rows] = graphs.cache().passes[
            (id(ev.consts), torch.device("cpu"), rows, False)].nbytes
    assert size[1] < size[2] < size[3]
    cache = graphs.PassCache(size[1] + size[3])
    graphs._thread.cache = cache
    for rows in (1, 2, 3, 1, 2, 3, 1):
        designs = _designs(spec, rows, rows)
        np.testing.assert_array_equal(ev.batch(designs),
                                      _plain(spec, f, designs)[0])
    # Eager first sightings, then captures of 1 and 2 rows; 3's capture
    # evicted both, and 1's capture again fits beside it.
    assert [k[2] for k in cache.passes] == [3, 1]
    assert cache.nbytes == size[1] + size[3] == cache.max_bytes
    assert len(card) == 3 + 4


def test_pass_cache_policy():
    cache = graphs.PassCache(10)
    for key in "abc":
        assert cache.find(key) == (None, False)
    assert cache.find("a") == (None, True)
    pa, pb, pc = (types.SimpleNamespace(nbytes=4) for _ in range(3))
    cache.add("a", pa)
    cache.add("b", pb)
    assert cache.find("a") == (pa, False)       # now most recently used
    cache.add("c", pc)
    assert list(cache.passes) == ["a", "c"] and cache.nbytes == 8
    assert cache.find("b") == (None, True)      # seen before: recapture
    big = types.SimpleNamespace(nbytes=50)
    cache.add("d", big)                         # alone over the bound
    assert list(cache.passes) == ["d"] and cache.nbytes == 50


def test_each_thread_keeps_its_own_passes(card):
    spec = spec_16()
    f = traffic_matrix(spec, "BFS")
    designs = _designs(spec, 3, 5)
    want = _plain(spec, f, designs)
    ev = Evaluator(spec, f, device="cpu")
    for _ in range(3):
        _same(ev.batch_aux(designs), want)
    mine = graphs.cache()
    seen = {}

    def work():
        seen["cache"] = graphs.cache()
        ev2 = Evaluator(spec, f, device="cpu")
        seen["rows"] = [ev2.batch_aux(designs) for _ in range(3)]
        seen["passes"] = len(graphs.cache().passes)

    t = threading.Thread(target=work)
    t.start()
    t.join()
    assert seen["cache"] is not mine and seen["passes"] == 1
    for got in seen["rows"]:
        _same(got, want)
    # Two captures: the main thread's, then the worker's own.
    assert len(card) == 2 and len(mine.passes) == 1


def test_a_pass_holds_what_its_graph_reads(card):
    spec = spec_16()
    f = traffic_matrix(spec, "BFS")
    ev = Evaluator(spec, f, device="cpu")
    designs = _designs(spec, 4, 9)
    for _ in range(2):
        ev.batch(designs)
    (p,) = graphs.cache().passes.values()
    assert p.consts is ev.consts and p.graph is card[0]
    assert p.f is not ev.f and p.f.data_ptr() != ev.f.data_ptr()
    assert p.nbytes == 1000 + sum(t.numel() * t.element_size()
                                  for t in (p.inputs, p.f, p.out))
    for v in p.views.values():
        assert v.untyped_storage().data_ptr() == \
            p.inputs.untyped_storage().data_ptr()
    alive = weakref.ref(ev.consts.vadj)
    want = ev.batch(designs)
    del ev
    make_consts.cache_clear()
    gc.collect()
    assert alive() is not None
    # New consts: a key of its own, first seen now, so run eagerly.
    ev = Evaluator(spec, f, device="cpu")
    np.testing.assert_array_equal(ev.batch(designs), want)
    assert len(card) == 1 and len(graphs.cache().seen) == 2


def test_the_traffic_matrix_is_refreshed_not_baked_in(card):
    spec = spec_16()
    fa, fb = traffic_matrix(spec, "BFS"), traffic_matrix(spec, "KNN")
    designs = _designs(spec, 5, 11)
    want_a, want_b = _plain(spec, fa, designs), _plain(spec, fb, designs)
    assert not np.array_equal(want_a[0], want_b[0])
    ea = Evaluator(spec, fa, device="cpu")
    for _ in range(2):
        _same(ea.batch_aux(designs), want_a)
    eb = Evaluator(spec, fb, device="cpu")
    for ev, want in ((eb, want_b), (eb, want_b), (ea, want_a), (eb, want_b)):
        _same(ev.batch_aux(designs), want)
    assert len(card) == 1 and card[0].replays == 5
    (p,) = graphs.cache().passes.values()
    assert p.f_src is eb.f and torch.equal(p.f, eb.f)


def test_graph_counters_split_chunks_by_how_they_ran(card):
    spec = spec_16()
    f = traffic_matrix(spec, "BFS")
    ev = Evaluator(spec, f, device="cpu", max_batch=2)
    with tracing.recording(), tracing.span(tracing.ROOT):
        # Chunks of 2 (eager, captured, replayed) and 1 (eager), then 1
        # (captured) and 1 (replayed).
        ev.batch(_designs(spec, 7, 1))
        ev.batch(_designs(spec, 1, 2))
        ev.batch(_designs(spec, 1, 3))
    counts = tracing.runs()[-1]["counts"]
    assert counts == {"noc.eval.graph.eager": 4,
                      "noc.eval.graph.capture": 2,
                      "noc.eval.graph.replay": 2}


def test_a_capture_records_launches_and_work_that_replays_count():
    """Meta inputs inside a work log take the card's path without
    launching: inside ``recorded`` their work goes to the record, and each
    ``replayed`` adds the record's launches and work."""
    cost = torch.empty((3, 8, 8), dtype=torch.float32, device="meta")
    outer = []
    before = ops.launches()
    with ops.work_log(outer):
        with ops.recorded() as rec:
            ops.apsp(cost, 4)
        assert outer == [] and [w.kernel for w in rec.works] == ["minplus"]
        rec.launches["minplus"] += 2
        rec.launches["walk"] += 1
        ops.replayed(rec)
        ops.replayed(rec)
    after = ops.launches()
    assert after["minplus"] - before["minplus"] == 4
    assert after["walk"] - before["walk"] == 2
    assert outer == rec.works * 2
    ops.replayed(rec)                          # no work log: launches only
    assert outer == rec.works * 2


@pytest.mark.parametrize("rows,n,tables", [(1, 8, False), (32, 64, False),
                                           (8, 36, True), (3, 5, True)])
def test_a_chunks_fields_lie_aligned_in_one_buffer(rows, n, tables):
    lay = graphs.layout(rows, n, tables)
    buf = torch.zeros(lay.nbytes, dtype=torch.uint8)
    v = lay.views(buf)
    assert list(v) == ["perm", "adj"] + (["dist", "nh"] if tables else [])
    ends = []
    for name, dt, shape, off in lay.fields:
        assert off % 256 == 0 and v[name].dtype == dt
        assert tuple(v[name].shape) == shape
        ends.append((off, off + v[name].numel() * dt.itemsize))
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    assert ends[-1][1] <= lay.nbytes
    v["perm"].fill_(-1)
    v["adj"].fill_(True)
    if tables:
        v["dist"].fill_(1.5)
        v["nh"].fill_(-2)
        assert float(v["dist"].sum()) == 1.5 * rows * n * n
    assert int(v["perm"].sum()) == -rows * n
    assert int(v["adj"].sum()) == rows * n * n


# ------------------------------------------------------------- the readers
READERS = ("graph_replay_share", "graph_replay_share.stage")


def _window(monkeypatch, recs, n=None):
    """A run of ``n`` searches (default: one a record) whose program kept
    ``recs``."""
    monkeypatch.setattr(tracing, "runs", lambda: list(recs))
    return types.SimpleNamespace(searches=[None] * (
        len(recs) if n is None else n))


@pytest.mark.parametrize("name", READERS)
def test_graph_replay_share_reads_nothing_without_its_counters(
        monkeypatch, name):
    read = harness.load_reader(name)
    assert read(_window(monkeypatch, [], 2)) is None
    recs = [{"spans": {}, "counts": {"noc.delta.served": 3}}] * 2
    assert read(_window(monkeypatch, recs)) is None
    few = [{"spans": {}, "counts": {"noc.eval.graph.replay": 5}}]
    assert read(_window(monkeypatch, few, 2)) is None      # too few


@pytest.mark.parametrize("name", READERS)
def test_graph_replay_share_is_replays_over_all_chunks(monkeypatch, name):
    read = harness.load_reader(name)
    older = {"spans": {}, "counts": {"noc.eval.graph.eager": 40}}
    recs = [{"spans": {}, "counts": {"noc.eval.graph.replay": 63,
                                     "noc.eval.graph.eager": 1,
                                     "noc.eval.graph.capture": 1}},
            {"spans": {}, "counts": {"noc.eval.graph.replay": 64}},
            {"spans": {}, "counts": {"noc.eval.graph.eager": 2}}]
    # The window's searches are the last records; the warm-up's is not read.
    assert read(_window(monkeypatch, [older] + recs, 3)) == pytest.approx(
        100.0 * 127 / 130)
    assert read(_window(monkeypatch, recs[2:])) == 0.0
    assert read(_window(monkeypatch, recs[1:2])) == 100.0
