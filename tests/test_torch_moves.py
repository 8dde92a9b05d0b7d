"""A neighbourhood's array form and the link-move cost, on the CPU.

``NeighborMoves.arrays`` is the one place the evaluator builds a
neighbourhood's candidates: it must give the stacked fields of
``materialize_all`` bit for bit, in the same order and dtypes, both the
port's and the reference's built from the same moves, and refuse the moves
``materialize`` refuses. ``routing.moved_cost`` is the one place a link move
changes a hop-cost matrix: it must give the reference's cost of the moved
adjacency. The guard proxies run their check once before every non-empty
call of the five entry points and pass everything else through."""

import numpy as np
import pytest
from repro.core.objectives import design_cost_np as ref_design_cost_np
from repro.core.problem import Design as RefDesign
from repro.core.problem import NeighborMoves as RefNeighborMoves
from repro.core.problem import spec_64 as ref_spec_64
from repro.core.problem import spec_large as ref_spec_large
from repro.core.problem import spec_tiny as ref_spec_tiny

from repro_torch.core import routing
from repro_torch.core.evaluate import Evaluator
from repro_torch.core.objectives import design_cost_np
from repro_torch.core.problem import (NeighborMoves, random_design,
                                      sample_neighbor_moves, spec_64,
                                      spec_large, spec_tiny)
from repro_torch.core.traffic import traffic_matrix
from repro_torch.dist.worker import _DeadlineGuard
from repro_torch.noc.api import Budget, BudgetedEvaluator


def _moves(spec, seed, n_swaps=12, n_link_moves=12):
    rng = np.random.default_rng(seed)
    return sample_neighbor_moves(spec, random_design(spec, rng), rng,
                                 n_swaps, n_link_moves)


def _ref_moves(mv):
    """The reference's neighbourhood of the same base and moves."""
    base = RefDesign(mv.base.perm.copy(), mv.base.adj.copy())
    return RefNeighborMoves(base, mv.swaps, mv.rem, mv.add)


SPECS = [(spec_tiny, ref_spec_tiny), (spec_64, ref_spec_64),
         (spec_large, ref_spec_large)]


@pytest.mark.parametrize("spec_fn,ref_spec_fn", SPECS,
                         ids=["tiny", "64", "large"])
def test_arrays_are_the_stacked_materialized_candidates(spec_fn, ref_spec_fn):
    spec = spec_fn()
    assert ref_spec_fn().n_tiles == spec.n_tiles
    for seed in range(3):
        mv = _moves(spec, seed)
        assert mv.swaps.shape[0] and mv.rem.shape[0]
        base_adj = mv.base.adj.copy()
        perms, adjs = mv.arrays()
        for designs in (mv.materialize_all(),
                        _ref_moves(mv).materialize_all()):
            want_p = np.stack([d.perm for d in designs])
            want_a = np.stack([d.adj for d in designs])
            assert perms.dtype == want_p.dtype and adjs.dtype == want_a.dtype
            assert np.array_equal(perms, want_p)
            assert np.array_equal(adjs, want_a)
        # The base design is left as it was.
        assert np.array_equal(mv.base.adj, base_adj)


def _invalid(spec, kind):
    d = spec.mesh_design()
    links = np.argwhere(np.triu(d.adj)).astype(np.int32)
    holes = np.argwhere(np.triu(spec.planar_pair_mask & ~d.adj)).astype(
        np.int32)
    none = np.zeros((0, 2), np.int32)
    if kind == "swap_self":
        return NeighborMoves(d, np.array([[0, 1], [3, 3]], np.int32), none,
                             none)
    rem, add = links[:2].copy(), holes[:2].copy()
    if kind == "remove_absent":
        rem[1] = holes[1]
    elif kind == "add_present":
        add[1] = links[0]
    elif kind == "self_link":
        add[1] = [2, 2]
    return NeighborMoves(d, none, rem, add)


@pytest.mark.parametrize("kind", ["swap_self", "remove_absent", "add_present",
                                  "self_link"])
def test_an_invalid_move_raises_from_both_forms(kind):
    mv = _invalid(spec_tiny(), kind)
    with pytest.raises(ValueError):
        mv.materialize_all()
    with pytest.raises(ValueError):
        mv.arrays()


@pytest.mark.parametrize("spec_fn,ref_spec_fn", SPECS[:2], ids=["tiny", "64"])
def test_moved_cost_is_the_cost_of_the_moved_adjacency(spec_fn, ref_spec_fn):
    spec, ref_spec = spec_fn(), ref_spec_fn()
    mv = _moves(spec, 5, 0, 16)
    cost = design_cost_np(spec, mv.base.adj)
    tables = routing.host_tables(cost, routing.apsp_iters(spec.n_tiles))
    ref_designs = _ref_moves(mv).materialize_all()
    for k, (rem, add) in enumerate(zip(mv.rem.tolist(), mv.add.tolist())):
        w = (np.float32(spec.router_stages)
             + np.float32(spec.link_delay[add[0], add[1]]))
        got = routing.moved_cost(cost, rem, add, w)
        assert got.dtype == np.float32
        assert np.array_equal(
            got, ref_design_cost_np(ref_spec, ref_designs[k].adj))
        moved = routing.delta_link_move(tables, rem, add, w)
        if moved is not None:
            assert np.array_equal(moved.cost, got)
    assert np.array_equal(cost, design_cost_np(spec, mv.base.adj))


ENTRY_POINTS = ("batch_aux", "batch", "batch_moves", "__call__", "edp")


def _guard(kind, ev):
    if kind == "budget":
        return BudgetedEvaluator(ev, Budget(max_evals=10**9, max_calls=10**9))
    return _DeadlineGuard(ev, float("inf"))


@pytest.mark.parametrize("entry", ENTRY_POINTS)
@pytest.mark.parametrize("kind", ["budget", "deadline"])
def test_a_guard_checks_once_per_non_empty_call(kind, entry):
    spec = spec_tiny()
    ev = Evaluator(spec, traffic_matrix(spec, "BFS"), device="cpu",
                   delta="on")
    guard = _guard(kind, ev)
    checks = []
    real = guard._check
    guard._check = lambda: (checks.append(entry), real())[1]
    mv = _moves(spec, 1, 4, 4)
    d = mv.base
    none = NeighborMoves(d, mv.swaps[:0], mv.rem[:0], mv.add[:0])
    full = {"batch_aux": [d, mv.materialize(0)], "batch": [d], "edp": d,
            "batch_moves": [mv], "__call__": d}[entry]
    empties = {"batch_aux": [[]], "batch": [[]],
               "batch_moves": [[], none, [none]]}.get(entry, [])
    call = guard if entry == "__call__" else getattr(guard, entry)
    raw = ev if entry == "__call__" else getattr(ev, entry)
    got = call(full)
    assert checks == [entry]
    if entry == "batch_aux":
        got = got[0]
    want = raw(full)
    np.testing.assert_array_equal(
        got, want[0] if entry == "batch_aux" else want)
    for empty in empties:
        call(empty)
    assert checks == [entry]
    # Everything else is the evaluator's own.
    assert (guard.n_evals, guard.n_calls) == (ev.n_evals, ev.n_calls)
    assert guard.delta_stats is ev.delta_stats
    assert (guard.max_batch, guard.delta_on) == (ev.max_batch, ev.delta_on)
    j = len(mv) - 1
    guard.note_accept(mv, j)
    assert np.packbits(mv.materialize(j).adj).tobytes() in ev._tab_cache
    assert checks == [entry]
