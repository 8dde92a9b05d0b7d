"""The port's batched Evaluator against the JAX reference, on the CPU.

Objective rows agree to rtol 1e-5: the reductions of Eqs. 1-10 run in f32
in another order than XLA's. Invalid designs come back as identical INF
rows, and the eval/call accounting is the reference's over the same calls.
Inside the port, the delta path is bit-equal to the dense path."""

import numpy as np
import pytest

from repro.core import Evaluator as RefEvaluator
from repro.core.problem import sample_neighbor_moves as ref_sample_moves
from repro_torch.core.evaluate import Evaluator
from repro_torch.core.problem import (Design, random_design,
                                      sample_neighbor_moves, spec_16, spec_36,
                                      spec_64, spec_tiny)
from repro_torch.core.traffic import traffic_matrix


def _designs(spec, n, seed):
    rng = np.random.default_rng(seed)
    return [spec.mesh_design()] + [random_design(spec, rng)
                                   for _ in range(n - 1)]


def _disconnected(spec):
    d = spec.mesh_design()
    return Design(perm=d.perm.copy(), adj=np.zeros_like(d.adj))


@pytest.mark.parametrize("spec_fn", [spec_tiny, spec_16, spec_36, spec_64])
def test_batch_aux_matches_reference(spec_fn):
    spec = spec_fn()
    f = traffic_matrix(spec, "BFS")
    designs = _designs(spec, 7, 3) + [_disconnected(spec)]
    ev = Evaluator(spec, f, device="cpu")
    rev = RefEvaluator(spec, f)
    objs, aux = ev.batch_aux(designs)
    robjs, raux = rev.batch_aux(designs)
    finite = robjs[:, 0] < 1e8
    assert not finite[-1]
    assert np.array_equal(objs[~finite], robjs[~finite])
    np.testing.assert_allclose(objs[finite], robjs[finite], rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(aux["net_lat"][finite],
                               raux["net_lat"][finite], rtol=1e-5)
    assert np.array_equal(aux["connected"], raux["connected"])
    assert (ev.n_evals, ev.n_calls) == (rev.n_evals, rev.n_calls)
    assert ev.edp(designs[0]) == pytest.approx(rev.edp(designs[0]),
                                               rel=1e-5)


def test_chunking_accounting_matches_reference():
    spec = spec_tiny()
    f = traffic_matrix(spec, "BP")
    designs = _designs(spec, 11, 4)
    ev = Evaluator(spec, f, device="cpu", max_batch=4)
    rev = RefEvaluator(spec, f, max_batch=4)
    np.testing.assert_allclose(ev.batch(designs), rev.batch(designs),
                               rtol=1e-5)
    mv = sample_neighbor_moves(spec, designs[1], np.random.default_rng(0),
                               6, 6)
    rmv = ref_sample_moves(spec, designs[1], np.random.default_rng(0), 6, 6)
    np.testing.assert_allclose(ev.batch_moves(mv), rev.batch_moves(rmv),
                               rtol=1e-5)
    assert (ev.n_evals, ev.n_calls) == (rev.n_evals, rev.n_calls) == (
        11 + len(mv), 3 + -(-len(mv) // 4))
    assert ev.max_batch == rev.max_batch


@pytest.mark.parametrize("spec_fn", [spec_tiny, spec_16])
def test_delta_on_bit_equal_off(spec_fn):
    spec = spec_fn()
    f = traffic_matrix(spec, "BFS")
    on = Evaluator(spec, f, device="cpu", delta="on")
    off = Evaluator(spec, f, device="cpu", delta="off")
    rng = np.random.default_rng(7)
    d = spec.mesh_design()
    for _ in range(4):
        mv = sample_neighbor_moves(spec, d, rng, 6, 6)
        assert np.array_equal(on.batch_moves(mv), off.batch_moves(mv))
        j = len(mv) - 1
        on.note_accept(mv, j)
        d = mv.materialize(j)
    assert on.delta_stats["delta"] > 0
    assert (on.n_evals, on.n_calls) == (off.n_evals, off.n_calls)


def test_evaluator_knobs_validated():
    spec = spec_tiny()
    f = traffic_matrix(spec, "BFS")
    with pytest.raises(ValueError, match="'auto'"):
        Evaluator(spec, f, device="cpu", backend="pallas")
    with pytest.raises(ValueError):
        Evaluator(spec, f, device="cpu", delta="maybe")
    with pytest.raises(ValueError):
        Evaluator(spec, f, device="meta")
