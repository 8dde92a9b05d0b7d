"""The port's batched Evaluator against the JAX reference, on the CPU.

On the CPU the port's walk is bit-equal to the reference's (the same
scatter-add order) and so is the thermal column; the other objectives sum
left to right, XLA:CPU's order on small dimensions, but XLA's order for a
given reduction also depends on the batch size it was compiled for, so
rows agree to a few f32 ulps, not bit for bit (ROADMAP.md Queue 3).
Invalid designs come back as identical INF rows, and the eval/call
accounting is the reference's over the same calls. Inside the port, the
delta path is bit-equal to the dense path."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Evaluator as RefEvaluator
from repro.core import routing as ref_routing
from repro.core.objectives import design_cost as ref_design_cost
from repro.core.objectives import make_consts as ref_make_consts
from repro.core.problem import sample_neighbor_moves as ref_sample_moves
from repro_torch.core.evaluate import Evaluator
from repro_torch.core.objectives import _walk_host_order
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


@pytest.mark.parametrize("spec_fn", [spec_tiny, spec_16, spec_64])
def test_cpu_walk_bit_equal_reference(spec_fn):
    spec = spec_fn()
    n = spec.n_tiles
    f = traffic_matrix(spec, "BFS").astype(np.float32)
    designs = _designs(spec, 6, 5)
    rc = ref_make_consts(spec)
    costs = jax.vmap(partial(ref_design_cost, rc))(
        jnp.asarray(np.stack([d.adj for d in designs])))
    _, nh = ref_routing.routing_tables_batched(costs, rc.apsp_iters)
    fs = np.stack([f[d.perm][:, d.perm] * (1 - np.eye(n, dtype=np.float32))
                   for d in designs]).astype(np.float32)
    walk = jax.jit(jax.vmap(ref_routing.walk_paths, in_axes=(0, None, 0, None)),
                   static_argnums=3)
    want = walk(nh, rc.link_delay, jnp.asarray(fs), rc.max_hops)
    got = _walk_host_order(torch.as_tensor(np.array(nh)),
                           torch.as_tensor(np.array(rc.link_delay)),
                           torch.from_numpy(fs), spec.max_hops)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("spec_fn", [spec_tiny, spec_16, spec_36, spec_64])
@pytest.mark.parametrize("traffic", ["BFS", "BP"])
def test_rows_within_ulps_of_reference(spec_fn, traffic):
    """Thermal column bit-equal, every other entry within 8 f32 ulps (at
    most 4 measured over these designs)."""
    spec = spec_fn()
    f = traffic_matrix(spec, traffic)
    designs = _designs(spec, 24, 6)
    got = Evaluator(spec, f, device="cpu").batch(designs).astype(np.float32)
    want = RefEvaluator(spec, f).batch(designs).astype(np.float32)
    assert np.array_equal(got[:, 4], want[:, 4])
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert int(ulps.max()) <= 8


# ------------------------------------------- the device tail's fixed order
def _pairwise_f32(row):
    """The pairwise halving sum of one row, in numpy f32 adds."""
    vals = [np.float32(v) for v in row]
    size = 1
    while size < len(vals):
        size *= 2
    vals += [np.float32(0.0)] * (size - len(vals))
    while len(vals) > 1:
        half = len(vals) // 2
        vals = [np.float32(a + b) for a, b in zip(vals[:half], vals[half:])]
    return vals[0]


@pytest.mark.parametrize("n", [1, 2, 3, 64, 100, 4096])
def test_fixed_sum_is_a_pairwise_sum_of_each_row(n):
    from repro_torch.core.objectives import _fixed_sum

    x = torch.as_tensor(np.random.default_rng(n).random((5, n),
                                                         dtype=np.float32))
    got = _fixed_sum(x, 1)
    want = np.array([_pairwise_f32(r) for r in x.numpy()], dtype=np.float32)
    assert np.array_equal(got.numpy(), want)
    for lo, hi in ((0, 1), (1, 4), (4, 5)):
        assert torch.equal(_fixed_sum(x[lo:hi], 1), got[lo:hi])
    y = x.reshape(5, 1, n) if n != 4096 else x.reshape(5, 64, 64)
    assert torch.equal(_fixed_sum(y, 2), got)


def _tail_inputs(spec, designs):
    """What ``evaluate_with_tables`` hands its tail, on the CPU."""
    from repro_torch.core import routing
    from repro_torch.core.objectives import design_cost, make_consts

    c = make_consts(spec, "cpu")
    f = torch.as_tensor(traffic_matrix(spec, "BFS"), dtype=torch.float32)
    perm = torch.as_tensor(np.stack([d.perm for d in designs]),
                           dtype=torch.int64)
    adj = torch.as_tensor(np.stack([d.adj for d in designs]))
    _, nh = routing.routing_tables_batched(design_cost(c, adj),
                                           c.apsp_iters)
    f_slots = f[perm[:, :, None], perm[:, None, :]] * (~c.eye).float()
    hops, delay, util_d, visits, _ = _walk_host_order(
        nh, c.link_delay, f_slots.contiguous(), c.max_hops)
    slot_type = c.core_types[perm]
    is_cpu, is_llc = slot_type == 0, slot_type == 1
    pair = ((is_cpu[:, :, None] & is_llc[:, None, :])
            | (is_llc[:, :, None] & is_cpu[:, None, :]))
    return c, (adj | c.vadj, adj, f_slots, hops, delay, util_d, visits, pair,
               c.core_power[perm])


@pytest.mark.parametrize("spec_fn", [spec_tiny, spec_64])
def test_device_tail_rows_do_not_depend_on_the_batch(spec_fn):
    """The card's objective tail gives a design the same bits in any batch
    (the ``spmd`` split's chunks, any chunking by ``max_batch``), within a
    few ulps of the host order's rows."""
    from repro_torch.core.objectives import _tail_device, _tail_host_order

    spec = spec_fn()
    c, args = _tail_inputs(spec, _designs(spec, 9, 5))
    objs, net_lat = _tail_device(c, *args)
    for lo, hi in ((0, 1), (1, 4), (4, 9), (8, 9)):
        part = _tail_device(c, *(a[lo:hi] for a in args))
        assert torch.equal(part[0], objs[lo:hi])
        assert torch.equal(part[1], net_lat[lo:hi])
    host_objs, host_net_lat = _tail_host_order(c, *args)
    np.testing.assert_allclose(objs.numpy(), np.asarray(host_objs),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(net_lat.numpy(), np.asarray(host_net_lat),
                               rtol=1e-5, atol=0)
