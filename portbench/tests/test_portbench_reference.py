"""The benchmark's plain reference against the port's CPU path.

The reference (``portbench.reference``) is float64 NumPy and imports
nothing of the program; here it is held to the port's evaluator, Pareto
filter and hypervolume at spec_tiny and spec_16, and its bfloat16 control
is shown to part from it by far more than float32 rounding."""

import dataclasses

import numpy as np
import pytest
from repro_torch.core.evaluate import Evaluator
from repro_torch.core.pareto import PhvContext, hypervolume, pareto_mask
from repro_torch.core.problem import (random_design, spec_16, spec_36,
                                      spec_64, spec_tiny)
from repro_torch.core.traffic import traffic_matrix

from portbench import reference

SPECS = {"tiny": spec_tiny, "16": spec_16}


def _designs(spec, n=12, seed=0):
    rng = np.random.default_rng(seed)
    ds = [spec.mesh_design()] + [random_design(spec, rng) for _ in range(n)]
    return ds, np.stack([d.perm for d in ds]), np.stack([d.adj for d in ds])


def _system(spec):
    return reference.System(**dataclasses.asdict(spec))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_objectives_match_the_port(name):
    spec = SPECS[name]()
    f = traffic_matrix(spec, "BFS")
    ds, perms, adjs = _designs(spec)
    prog, aux = Evaluator(spec, f, device="cpu").batch_aux(ds)
    rows, net_lat, valid = reference.objectives(_system(spec), f, perms, adjs)
    assert valid.all()
    # float32 program against float64 reference.
    np.testing.assert_allclose(prog, rows, rtol=2e-6)
    np.testing.assert_allclose(aux["net_lat"], net_lat, rtol=2e-6)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_bfloat16_control_parts_from_the_reference(name):
    spec = SPECS[name]()
    f = traffic_matrix(spec, "HS")
    _, perms, adjs = _designs(spec, seed=1)
    sy = _system(spec)
    rows, _, _ = reference.objectives(sy, f, perms, adjs)
    ctl, _, _ = reference.objectives(sy, f, perms, adjs,
                                     precision="bfloat16")
    gap = np.abs(ctl - rows) / np.abs(rows)
    assert gap.max() > 1e-3


def test_paths_beyond_max_hops_are_invalid_on_both_sides():
    spec = dataclasses.replace(spec_16(), max_hops=2)
    f = traffic_matrix(spec, "BFS")
    ds, perms, adjs = _designs(spec, n=4)
    prog = Evaluator(spec, f, device="cpu").batch(ds)
    rows, _, valid = reference.objectives(_system(spec), f, perms, adjs)
    assert not valid.any()
    assert (prog >= reference.INF).all() and (rows >= reference.INF).all()


@pytest.mark.parametrize("make", [spec_tiny, spec_16, spec_36, spec_64])
def test_geometry_matches_the_port(make):
    spec = make()
    sy = _system(spec)
    assert sy.n_tiles == spec.n_tiles
    assert sy.n_links == spec.n_links
    assert sy.n_planar_links == spec.n_planar_links
    np.testing.assert_array_equal(sy.vadj, spec.vertical_adj)
    np.testing.assert_array_equal(sy.planar_mask, spec.planar_pair_mask)
    np.testing.assert_array_equal(sy.link_delay, spec.link_delay)
    np.testing.assert_array_equal(sy.manhattan, spec.manhattan)
    np.testing.assert_array_equal(sy.core_power, spec.core_power)
    perm, adj = sy.mesh()
    mesh = spec.mesh_design()
    np.testing.assert_array_equal(perm, mesh.perm)
    np.testing.assert_array_equal(adj, mesh.adj)
    assert sy.design_faults(perm, adj) == []


def test_design_faults_name_each_broken_guarantee():
    sy = _system(spec_16())
    perm, adj = sy.mesh()
    bad_perm = perm.copy()
    bad_perm[0] = bad_perm[1]
    assert "placement is not a permutation" in sy.design_faults(bad_perm, adj)
    asym = adj.copy()
    asym[0, 1] = not asym[0, 1]
    assert "links are not symmetric" in sy.design_faults(perm, asym)
    cross = adj.copy()
    cross[0, 8] = cross[8, 0] = True          # slot 8 is on layer 1
    faults = sy.design_faults(perm, cross)
    assert "a link joins two layers or a tile to itself" in faults
    assert any("planar links, not" in x for x in faults)


def test_pareto_and_hypervolume_match_the_port():
    rng = np.random.default_rng(3)
    for m in (2, 3, 5):
        pts = rng.uniform(0.2, 1.8, size=(30, m))
        np.testing.assert_array_equal(reference.pareto_mask(pts),
                                      pareto_mask(pts))
        ref = np.full(m, reference.REF_SCALE)
        assert reference.hypervolume(pts, ref) == pytest.approx(
            hypervolume(pts, ref), rel=1e-12)
    dup = np.array([[1.0, 2.0], [1.0, 2.0], [0.5, 3.0], [2.0, 2.5]])
    np.testing.assert_array_equal(reference.pareto_mask(dup),
                                  pareto_mask(dup))


def test_front_phv_is_the_port_phv_context():
    spec = spec_16()
    f = traffic_matrix(spec, "BFS")
    ds, perms, adjs = _designs(spec, n=20, seed=4)
    rows, _, _ = reference.objectives(_system(spec), f, perms, adjs)
    for obj_idx in ((0, 1, 2, 3, 4), (0, 1), (4,)):
        ctx = PhvContext(rows[0], obj_idx)
        front = rows[1:]
        assert reference.front_phv(front, rows[0], obj_idx) == pytest.approx(
            ctx.phv(front), rel=1e-12)


def test_round_bf16_is_round_to_nearest_even():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1e9, -2.5, 0.0])
    out = reference.round_bf16(x)
    np.testing.assert_array_equal(out[[0, 3, 4, 5]],
                                  [1.0, 998244352.0, -2.5, 0.0])
    assert out[1] == 1.0                       # tie: to even
    assert out[2] == 1.0 + 2 ** -6             # tie: to even, upward


def test_system_rejects_core_counts_that_do_not_fill_it():
    with pytest.raises(ValueError):
        reference.System(2, 2, 2, 1, 2, 4)
