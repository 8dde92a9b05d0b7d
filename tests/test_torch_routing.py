"""Routing of the PyTorch port against the JAX reference, on the CPU.

APSP (kernel K1's plain version), next hops and the host mirrors must be
bit-equal to ``repro.core.routing`` and to the reference Pallas min-plus
kernel run in interpret mode: every finite path cost is a small integer,
exact in f32, and min/add/argmin are exact. The walk (kernel K4's plain
version) must give bit-equal hop counts and delay sums; utilization and
router visits are sums of f32 flows in another order than the reference's
scatter-add, so they agree to rtol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import routing as ref_routing
from repro.core.objectives import design_cost_np as ref_design_cost_np
from repro.core.problem import (random_design, spec_16, spec_64,
                                spec_tiny)
from repro.kernels.link_util import walk_accumulate
from repro.kernels.minplus import minplus as pallas_minplus
from repro_torch.core import routing
from repro_torch.core.objectives import design_cost_np
from repro_torch.kernels import ops, ref

INF = np.float32(1e9)


def _sparse(rng, shape, p_edge=0.3, zero_diag=True):
    """INF-sparse graphs of small integer weights; with ``zero_diag`` they
    are hop-cost matrices like the evaluator's."""
    w = rng.integers(1, 20, size=shape).astype(np.float32)
    w[rng.random(shape) > p_edge] = INF
    if zero_diag:
        idx = np.arange(shape[-1])
        w[..., idx, idx] = 0.0
    return w


def _designs(spec, n, seed):
    rng = np.random.default_rng(seed)
    return [spec.mesh_design()] + [random_design(spec, rng)
                                   for _ in range(n - 1)]


@pytest.mark.parametrize("n", [7, 33, 129])
def test_minplus_bit_equal_reference_and_pallas(n):
    rng = np.random.default_rng(n)
    a, b = _sparse(rng, (2, n, n)), _sparse(rng, (2, n, n))
    got = ops.minplus(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for i in range(2):
        want = np.asarray(ref_routing.min_plus(jnp.asarray(a[i]),
                                               jnp.asarray(b[i])))
        assert np.array_equal(got[i], want)
    pallas = np.asarray(pallas_minplus(jnp.asarray(a), jnp.asarray(b),
                                       interpret=True))
    assert np.array_equal(got, pallas)


@pytest.mark.parametrize("n", [7, 33])
def test_minplus_true_minimum_without_zero_diagonal(n):
    """Rows with no finite path sum to INF + INF: the port keeps the true
    minimum, as the reference's dense jnp min_plus does."""
    rng = np.random.default_rng(n + 1)
    a = _sparse(rng, (2, n, n), zero_diag=False)
    b = _sparse(rng, (2, n, n), zero_diag=False)
    got = ops.minplus(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for i in range(2):
        want = np.asarray(ref_routing.min_plus(jnp.asarray(a[i]),
                                               jnp.asarray(b[i])))
        assert np.array_equal(got[i], want)


def test_minplus_blocked_above_dense_nmax():
    rng = np.random.default_rng(300)
    a, b = _sparse(rng, (1, 300, 300)), _sparse(rng, (1, 300, 300))
    got = ops.minplus(torch.from_numpy(a), torch.from_numpy(b)).numpy()[0]
    want = np.asarray(ref_routing.min_plus_blocked(jnp.asarray(a[0]),
                                                   jnp.asarray(b[0])))
    assert np.array_equal(got, want)
    assert np.array_equal(got, ref_routing.min_plus_np(a[0], b[0]))


@pytest.mark.parametrize("spec_fn", [spec_tiny, spec_16, spec_64])
def test_routing_tables_bit_equal_reference(spec_fn):
    spec = spec_fn()
    designs = _designs(spec, 6, 1)
    costs = np.stack([design_cost_np(spec, d.adj) for d in designs])
    assert np.array_equal(
        costs, np.stack([ref_design_cost_np(spec, d.adj) for d in designs]))
    iters = routing.apsp_iters(spec.n_tiles)
    dist, nh = routing.routing_tables_batched(torch.from_numpy(costs), iters)
    rdist, rnh = ref_routing.routing_tables_batched(jnp.asarray(costs), iters,
                                                    backend="jnp")
    assert np.array_equal(dist.numpy(), np.asarray(rdist))
    assert np.array_equal(nh.numpy(), np.asarray(rnh))
    assert nh.dtype == torch.int32


def _walk_inputs(spec, seed, n_designs=4):
    designs = _designs(spec, n_designs, seed)
    costs = np.stack([design_cost_np(spec, d.adj) for d in designs])
    iters = routing.apsp_iters(spec.n_tiles)
    nh = np.stack([ref_routing.next_hop_np(c, ref_routing.apsp_np(c, iters))
                   for c in costs]).astype(np.int32)
    rng = np.random.default_rng(seed + 100)
    f = rng.uniform(0.0, 1.0, size=nh.shape).astype(np.float32)
    f[:, np.arange(spec.n_tiles), np.arange(spec.n_tiles)] = 0.0
    return nh, f, spec.link_delay.astype(np.float32)


@pytest.mark.parametrize("spec_fn", [spec_tiny, spec_16, spec_64])
def test_walk_matches_reference_walk_paths(spec_fn):
    spec = spec_fn()
    nh, f, delay = _walk_inputs(spec, 2)
    hops, dsum, util, visits, done = routing.walk_paths(
        torch.from_numpy(nh), torch.from_numpy(delay), torch.from_numpy(f),
        spec.max_hops)
    for i in range(nh.shape[0]):
        rh, rd, ru, rv, rdone = ref_routing.walk_paths(
            jnp.asarray(nh[i]), jnp.asarray(delay), jnp.asarray(f[i]),
            spec.max_hops)
        assert np.array_equal(hops[i].numpy(), np.asarray(rh))
        assert np.array_equal(dsum[i].numpy(), np.asarray(rd))
        assert bool(done[i]) == bool(rdone)
        assert bool(rdone)
        np.testing.assert_allclose(util[i].numpy(), np.asarray(ru),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(visits[i].numpy(), np.asarray(rv),
                                   rtol=1e-6)


def test_walk_matches_pallas_link_util_interpret():
    spec = spec_16()
    nh, f, delay = _walk_inputs(spec, 3, n_designs=2)
    hops, dsum, util, visits, _ = ops.walk(
        torch.from_numpy(nh), torch.from_numpy(f), torch.from_numpy(delay),
        spec.max_hops)
    for i in range(nh.shape[0]):
        ph, pd, pu, pv = walk_accumulate(
            jnp.asarray(nh[i]), jnp.asarray(f[i]), jnp.asarray(delay),
            max_hops=spec.max_hops, interpret=True)
        assert np.array_equal(hops[i].numpy(), np.asarray(ph).astype(np.int32))
        assert np.array_equal(dsum[i].numpy(), np.asarray(pd))
        np.testing.assert_allclose(util[i].numpy(), np.asarray(pu),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(visits[i].numpy(), np.asarray(pv),
                                   rtol=1e-6)


def _walk_loop_oracle(nh, f, max_hops):
    """Scalar loops in the CUDA kernel's order (csrc/walk.cu): in-tree
    flows pulled from children in ascending order, level by level; util
    and visits accumulated over destinations in ascending order."""
    n = nh.shape[0]
    hops = np.zeros((n, n), np.int64)
    for s in range(n):
        for d in range(n):
            cur, h = s, 0
            while h < max_hops and cur != d:
                cur, h = nh[cur, d], h + 1
            hops[s, d] = h
    util = np.zeros((n, n), np.float32)
    vis = np.zeros(n, np.float32)
    for d in range(n):
        flow = f[:, d].copy()
        for level in range(hops[:, d].max() - 1, 0, -1):
            for u in np.flatnonzero(hops[:, d] == level):
                acc = flow[u]
                for v in range(n):
                    if nh[v, d] == u and hops[v, d] == level + 1:
                        acc = np.float32(acc + flow[v])
                flow[u] = acc
        for u in range(n):
            if u != d:
                util[u, nh[u, d]] = np.float32(util[u, nh[u, d]] + flow[u])
                vis[u] = np.float32(vis[u] + flow[u])
    col = np.zeros(n, np.float32)
    for s in range(n):
        col = (col + f[s]).astype(np.float32)
    return util, (vis + col).astype(np.float32)


def test_walk_plain_version_sums_in_kernel_order():
    """The plain walk's util/visits are bit-equal to scalar loops in the
    CUDA kernel's summation order — what makes card and CPU agree."""
    spec = spec_16()
    nh, f, delay = _walk_inputs(spec, 4, n_designs=2)
    _, _, util, visits, _ = ref.walk_ref(
        torch.from_numpy(nh), torch.from_numpy(f), torch.from_numpy(delay),
        spec.max_hops)
    for i in range(nh.shape[0]):
        u, v = _walk_loop_oracle(nh[i], f[i], spec.max_hops)
        assert np.array_equal(util[i].numpy(), u)
        assert np.array_equal(visits[i].numpy(), v)


def test_walk_disconnected_design_matches_reference():
    """Only the vertical TSVs: next hops of unreachable pairs follow the
    reference's INF ties, and hops, delays and all_done still agree."""
    spec = spec_tiny()
    adj = np.zeros_like(spec.mesh_design().adj)
    cost = design_cost_np(spec, adj)
    iters = routing.apsp_iters(spec.n_tiles)
    dist, nh = routing.routing_tables_batched(torch.from_numpy(cost[None]),
                                              iters)
    delay = spec.link_delay.astype(np.float32)
    f = np.ones_like(cost)
    hops, dsum, _, _, done = routing.walk_paths(
        nh, torch.from_numpy(delay), torch.from_numpy(f[None]), spec.max_hops)
    rh, rd, _, _, rdone = ref_routing.walk_paths(
        jnp.asarray(nh[0].numpy()), jnp.asarray(delay), jnp.asarray(f),
        spec.max_hops)
    assert np.array_equal(hops[0].numpy(), np.asarray(rh))
    assert np.array_equal(dsum[0].numpy(), np.asarray(rd))
    assert bool(done[0]) == bool(rdone)
    assert bool((dist >= INF / 2).any())


@pytest.mark.parametrize("spec_fn", [spec_tiny, spec_16])
def test_host_mirror_and_delta_bit_equal_reference(spec_fn):
    spec = spec_fn()
    iters = routing.apsp_iters(spec.n_tiles)
    rng = np.random.default_rng(5)
    from repro_torch.core.problem import sample_neighbor_moves
    d = spec.mesh_design()
    cost = design_cost_np(spec, d.adj)
    t, rt = routing.host_tables(cost, iters), ref_routing.host_tables(cost,
                                                                      iters)
    n_delta = 0
    for _ in range(12):
        for field in rt._fields:
            assert np.array_equal(getattr(t, field), getattr(rt, field))
        mv = sample_neighbor_moves(spec, d, rng, 0, 2)
        rem, add = tuple(mv.rem[0]), tuple(mv.add[0])
        w = float(np.float32(spec.router_stages)
                  + np.float32(spec.link_delay[add[0], add[1]]))
        t2 = routing.delta_link_move(t, rem, add, w)
        rt2 = ref_routing.delta_link_move(rt, rem, add, w)
        assert (t2 is None) == (rt2 is None)
        d = mv.materialize(0)
        if t2 is None:
            c2 = design_cost_np(spec, d.adj)
            t2, rt2 = routing.host_tables(c2, iters), ref_routing.host_tables(
                c2, iters)
        else:
            n_delta += 1
        t, rt = t2, rt2
    assert n_delta > 0


def test_routing_backend_knob():
    assert routing.resolve_backend(None) == "auto"
    for old in ("jnp", "pallas"):
        with pytest.raises(ValueError, match="'auto'"):
            routing.resolve_backend(old)
    with pytest.raises(ValueError):
        routing.resolve_backend("nope")
