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
from repro.kernels.minplus import apsp as pallas_apsp
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


def _apsp_fixed_loop(d, n_iters):
    for _ in range(n_iters):
        d = ref.minplus_ref(d, d)
    return d


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("n,p_edge,diag", [
    (7, 0.3, "zero"), (33, 0.1, "zero"), (64, 0.05, "zero"),
    (129, 0.03, "zero"), (33, 0.1, "none"), (64, 0.05, "half")])
def test_apsp_early_exit_equals_fixed_loop(n, p_edge, diag):
    """The plain APSP stops at the first squaring that changes nothing (as
    the one-launch kernel does per design): bit-equal to the fixed
    ``n_iters`` loop on INF-sparse graphs, odd N, and graphs without a
    zero diagonal (or with one on half the nodes)."""
    rng = np.random.default_rng(n)
    w = _sparse(rng, (3, n, n), p_edge, zero_diag=diag == "zero")
    if diag == "half":
        idx = np.arange(0, n, 2)
        w[:, idx, idx] = 0.0
    cost = torch.from_numpy(w)
    iters = routing.apsp_iters(n)
    got = ops.apsp(cost, iters)
    assert torch.equal(_bits(got), _bits(_apsp_fixed_loop(cost, iters)))
    if diag != "zero":
        # The reference's dense jnp min-plus keeps the true minimum too.
        for i in range(w.shape[0]):
            d = jnp.asarray(w[i])
            for _ in range(iters):
                d = ref_routing.min_plus(d, d)
            assert np.array_equal(got[i].numpy(), np.asarray(d))
        return
    # A converged APSP with a zero diagonal is a fixed point, so the early
    # exit did stop before the last squaring.
    assert torch.equal(ref.minplus_ref(got, got), got)
    for i in range(w.shape[0]):
        assert np.array_equal(got[i].numpy(), routing.apsp_np(w[i], iters))
    if n <= 33:
        assert np.array_equal(got.numpy(), np.asarray(
            pallas_apsp(jnp.asarray(w), iters, interpret=True)))


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


def _walk_two_pass_oracle(nh, f, delay, max_hops):
    """Scalar loops in the order of the CUDA kernel's two passes
    (csrc/walk.cu). Pass 1 per destination d: walks through the column,
    sibling lists (next higher v with the same parent, lowest child first),
    leaves-in levels over the child lists, and (parent, flow) into a
    scratch. Pass 2 per slot u: util row and visits over d ascending from
    that scratch, then the column sum of f. The group of destinations a
    kernel block holds only sets how many empty levels it runs."""
    n = nh.shape[0]
    hops = np.zeros((n, n), np.int32)
    dsum = np.zeros((n, n), np.float32)
    parent_t = np.zeros((n, n), np.int64)           # [d][u]
    flow_t = np.zeros((n, n), np.float32)           # [d][u]
    all_done = True
    for d in range(n):
        for u in range(n):
            cur, h, acc = u, 0, np.float32(0.0)
            while h < max_hops and cur != d:
                nxt = nh[cur, d]
                acc = np.float32(acc + delay[cur, nxt])
                h, cur = h + 1, nxt
            all_done &= bool(cur == d)
            hops[u, d], dsum[u, d] = h, acc
        col = nh[:, d]
        first = np.full(n, -1)
        sib = np.full(n, -1)
        for u in range(n):
            later = np.flatnonzero(col[u + 1:] == col[u])
            sib[u] = u + 1 + later[0] if later.size else -1
            if not (col[:u] == col[u]).any():
                first[col[u]] = u
        flow = f[:, d].copy()
        h = hops[:, d]
        for level in range(h.max() - 1, 0, -1):
            for u in np.flatnonzero(h == level):
                acc, v = flow[u], first[u]
                while v >= 0:
                    if h[v] == level + 1:
                        acc = np.float32(acc + flow[v])
                    v = sib[v]
                flow[u] = acc
        parent_t[d], flow_t[d] = col, flow
    util = np.zeros((n, n), np.float32)
    visits = np.zeros(n, np.float32)
    for u in range(n):
        vis = np.float32(0.0)
        for d in range(n):
            if d != u:
                p = parent_t[d, u]
                util[u, p] = np.float32(util[u, p] + flow_t[d, u])
                vis = np.float32(vis + flow_t[d, u])
        colsum = np.float32(0.0)
        for s in range(n):
            colsum = np.float32(colsum + f[s, u])
        visits[u] = np.float32(vis + colsum)
    return hops, dsum, util, visits, all_done


def _disconnected_walk_inputs():
    """spec_tiny with only its vertical TSVs, f = 1 everywhere."""
    spec = spec_tiny()
    adj = np.zeros_like(spec.mesh_design().adj)
    cost = design_cost_np(spec, adj)
    _, nh = routing.routing_tables_batched(
        torch.from_numpy(cost[None]), routing.apsp_iters(spec.n_tiles))
    return (nh.numpy(), np.ones((1,) + cost.shape, np.float32),
            spec.link_delay.astype(np.float32), spec.max_hops)


@pytest.mark.parametrize("case", ["16", "tiny", "64", "disconnected", "cut"])
def test_walk_plain_version_sums_in_kernel_order(case):
    """The plain walk's outputs are bit-equal to scalar loops in the CUDA
    kernel's two-pass order — what makes card and CPU agree — on spec_16,
    spec_tiny, spec_64, a disconnected design, and spec_16 walks cut at 2
    hops (pairs left unreached): hops, delays, util, visits and
    all_done."""
    if case == "disconnected":
        nh, f, delay, max_hops = _disconnected_walk_inputs()
    elif case == "cut":
        nh, f, delay = _walk_inputs(spec_16(), 7, n_designs=2)
        max_hops = 2
    else:
        spec = {"tiny": spec_tiny, "16": spec_16, "64": spec_64}[case]()
        nh, f, delay = _walk_inputs(spec, 4, n_designs=2)
        max_hops = spec.max_hops
    got = ref.walk_ref(torch.from_numpy(nh), torch.from_numpy(f),
                       torch.from_numpy(delay), max_hops)
    for i in range(nh.shape[0]):
        want = _walk_two_pass_oracle(nh[i], f[i], delay, max_hops)
        for a, b in zip(got[:4], want[:4]):
            assert np.array_equal(a[i].numpy(), b)
        assert bool(got[4][i]) == want[4]
    if case == "cut":
        assert not bool(got[4].any())


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
