"""NSGA-II's variation and the neighbour sampler, on the CPU against the JAX
reference, bit for bit.

The port builds a generation's children in one pass over rows
(``core/nsga2.py::_vary``); the reference builds them one ``Design`` at a
time: two tournaments, ``_crossover``, and with probability ``p_mutate``
``sample_neighbors(spec, child, rng, 1, 1)`` and a uniform pick. Both must
give the same children and leave the generator in the same state. The
port's sampler draws through ``problem.draw_neighbor_moves``, shared with
the variation's mutation; it must give the reference's moves and stream
for every caller's knobs."""

import numpy as np
import pytest

from repro.core import problem as ref_problem
from repro.core.nsga2 import _crossover as ref_crossover
from repro_torch.core import problem
from repro_torch.core.nsga2 import _vary

SPECS = ("spec_16", "spec_36", "spec_64", "spec_large")


def _ref_vary(spec, pop, rank, crowd, rng, p_mutate):
    """The reference's per-child loop, as its ``nsga2`` runs it (one child
    per member of the population)."""
    def tournament():
        i, j = rng.integers(len(pop), size=2)
        if rank[i] < rank[j] or (rank[i] == rank[j] and crowd[i] > crowd[j]):
            return pop[i]
        return pop[j]

    children = []
    while len(children) < len(pop):
        c = ref_crossover(spec, tournament(), tournament(), rng)
        if rng.random() < p_mutate:
            nb = ref_problem.sample_neighbors(spec, c, rng, 1, 1)
            if nb:
                c = nb[rng.integers(len(nb))]
        children.append(c)
    return children


def _population(spec, kind, seed, size=10):
    """(designs, rank, crowd): ``"ties"`` random designs whose ranks and
    crowding repeat; ``"identical"`` one design ``size`` times with equal
    scores, so every crossover's parents share all their links."""
    rng = np.random.default_rng(1000 + seed)
    if kind == "identical":
        d = problem.random_design(spec, rng)
        return ([d.copy() for _ in range(size)], np.zeros(size, np.int64),
                np.ones(size))
    pop = [problem.random_design(spec, rng) for _ in range(size - 1)]
    pop.append(spec.mesh_design())
    rank = rng.integers(0, 2, size)
    crowd = rng.choice([np.inf, 0.5, 1.0], size)
    return pop, rank, crowd


@pytest.mark.parametrize("kind", ["ties", "identical"])
@pytest.mark.parametrize("p_mutate", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("spec_name", SPECS)
def test_variation_gives_the_reference_loops_children(spec_name, seed,
                                                      p_mutate, kind):
    spec = getattr(problem, spec_name)()
    ref_spec = getattr(ref_problem, spec_name)()
    pop, rank, crowd = _population(spec, kind, seed)
    ref_pop = [ref_problem.Design(d.perm.copy(), d.adj.copy()) for d in pop]
    rng = np.random.default_rng(seed)
    ref_rng = np.random.default_rng(seed)
    # Two generations from one generator: the stream must line up after
    # the first as well.
    got = (_vary(spec, pop, rank, crowd, rng, p_mutate)
           + _vary(spec, pop, rank, crowd, rng, p_mutate))
    want = (_ref_vary(ref_spec, ref_pop, rank, crowd, ref_rng, p_mutate)
            + _ref_vary(ref_spec, ref_pop, rank, crowd, ref_rng, p_mutate))
    assert rng.bit_generator.state == ref_rng.bit_generator.state
    iu0, iu1 = np.triu_indices(spec.n_tiles, 1)
    for c, w in zip(got, want, strict=True):
        assert c.perm.dtype == np.int32 and c.adj.dtype == np.bool_
        np.testing.assert_array_equal(c.perm, w.perm)
        np.testing.assert_array_equal(c.adj, w.adj)
        np.testing.assert_array_equal(c.adj, c.adj.T)
        assert int(c.adj[iu0, iu1].sum()) == spec.n_planar_links
        assert not (c.adj & ~spec.planar_pair_mask).any()
        np.testing.assert_array_equal(np.sort(c.perm),
                                      np.arange(spec.n_tiles))


def _sampler_design(spec, kind, seed):
    """``"random"``: a random design; ``"full_layer"``: every same-layer
    pair of layer 0 linked (no holes there) plus a random few elsewhere;
    ``"no_holes"``: every planar pair linked, so no link move is drawn."""
    rng = np.random.default_rng(2000 + seed)
    d = problem.random_design(spec, rng)
    if kind == "random":
        return d
    mask = spec.planar_pair_mask
    if kind == "no_holes":
        return problem.Design(d.perm, mask.copy())
    layer0 = spec.layer_of_slot == 0
    adj = mask & layer0[:, None] & layer0[None, :]
    others = d.adj & ~(layer0[:, None] | layer0[None, :])
    return problem.Design(d.perm, adj | others)


@pytest.mark.parametrize("kind", ["random", "full_layer", "no_holes"])
@pytest.mark.parametrize("knobs", [(0, 8), (8, 0), (1, 1), (20, 20)])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("spec_name", ["spec_36", "spec_64"])
def test_sampler_draws_the_reference_moves(spec_name, seed, knobs, kind):
    spec = getattr(problem, spec_name)()
    ref_spec = getattr(ref_problem, spec_name)()
    d = _sampler_design(spec, kind, seed)
    ref_d = ref_problem.Design(d.perm.copy(), d.adj.copy())
    rng = np.random.default_rng(seed)
    ref_rng = np.random.default_rng(seed)
    for _ in range(3):
        got = problem.sample_neighbor_moves(spec, d, rng, *knobs)
        want = ref_problem.sample_neighbor_moves(ref_spec, ref_d, ref_rng,
                                                 *knobs)
        for name in ("swaps", "rem", "add"):
            g, w = getattr(got, name), getattr(want, name)
            assert (g.dtype, g.shape) == (w.dtype, w.shape), name
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert rng.bit_generator.state == ref_rng.bit_generator.state
    if kind == "no_holes":
        assert len(got.rem) == 0
