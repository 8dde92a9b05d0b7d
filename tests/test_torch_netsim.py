"""The port's flit simulator against the reference's: host numpy on both
sides with the same rng streams, so the same seed gives the same bits.
Also the reference's own contracts (tests/test_netsim.py) on the port:
the vectorized engine against the per-cycle loop, the idle network, the
host tables against the device tables the evaluator builds, the
disconnected design, the byte-bounded table cache, and Fig. 4's
direction."""

import numpy as np
import pytest
import torch

from repro.core import netsim as ref_netsim
from repro_torch.core import netsim, routing
from repro_torch.core.evaluate import Evaluator
from repro_torch.core.objectives import design_cost, make_consts
from repro_torch.core.problem import random_design, spec_16, spec_tiny
from repro_torch.core.traffic import traffic_matrix

STATS = ("delivered", "throughput", "offered", "mean_latency", "p99_latency")


def _assert_same_result(got: dict, want: dict):
    assert got["delivered"] == want["delivered"]
    for k in ("throughput", "offered", "mean_latency", "p99_latency"):
        g, w = float(got[k]), float(want[k])
        if np.isinf(w):
            assert np.isinf(g)
        else:
            assert g == pytest.approx(w, rel=1e-12, abs=1e-12), k


def _equal_bits(got: dict, want: dict):
    for k in STATS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("spec_fn,app", [(spec_tiny, "BP"), (spec_16, "BFS")])
@pytest.mark.parametrize("load", ["light", "saturated"])
def test_simulate_equals_reference_bits(spec_fn, app, load):
    spec = spec_fn()
    f = traffic_matrix(spec, app)
    scale = 0.4 if load == "light" else 12.0 / max(f.sum(), 1e-9)
    rng = np.random.default_rng(5)
    for d in (spec.mesh_design(), random_design(spec, rng)):
        for seed in (0, 3):
            kw = dict(inj_scale=scale, cycles=600, warmup=120, seed=seed)
            _equal_bits(netsim.simulate(spec, d, f, **kw),
                        ref_netsim.simulate(spec, d, f, **kw))


def test_simulate_batch_and_sweeps_equal_reference_bits():
    spec = spec_tiny()
    f = traffic_matrix(spec, "BP")
    rng = np.random.default_rng(9)
    designs = [spec.mesh_design(), random_design(spec, rng)]
    kw = dict(scales=(0.5, 2.0), seeds=(0, 4), cycles=400, warmup=100)
    _equal_bits(netsim.simulate_batch(spec, designs, f, **kw),
                ref_netsim.simulate_batch(spec, designs, f, **kw))
    d = designs[1]
    _equal_bits(netsim.simulate_reference(spec, d, f, inj_scale=2.0,
                                          cycles=300, warmup=60, seed=1),
                ref_netsim.simulate_reference(spec, d, f, inj_scale=2.0,
                                              cycles=300, warmup=60, seed=1))
    assert netsim.saturation_throughput(spec, d, f, cycles=300) == \
        ref_netsim.saturation_throughput(spec, d, f, cycles=300)
    np.testing.assert_array_equal(
        netsim.saturation_throughput_batch(spec, designs, f, cycles=300),
        ref_netsim.saturation_throughput_batch(spec, designs, f, cycles=300))
    assert netsim.simulated_edp(spec, d, f, energy=2.5, cycles=300) == \
        ref_netsim.simulated_edp(spec, d, f, energy=2.5, cycles=300)


@pytest.mark.parametrize("spec_fn,app", [(spec_tiny, "BP"), (spec_16, "BFS")])
def test_vectorized_engine_matches_reference_loop(spec_fn, app):
    spec = spec_fn()
    f = traffic_matrix(spec, app)
    rng = np.random.default_rng(5)
    for scale in (0.4, 12.0 / max(f.sum(), 1e-9)):
        for d in (spec.mesh_design(), random_design(spec, rng)):
            kw = dict(inj_scale=scale, cycles=600, warmup=120, seed=3)
            _assert_same_result(netsim.simulate(spec, d, f, **kw),
                                netsim.simulate_reference(spec, d, f, **kw))


def test_simulate_batch_matches_individual_runs():
    spec = spec_tiny()
    f = traffic_matrix(spec, "BP")
    rng = np.random.default_rng(9)
    designs = [spec.mesh_design(), random_design(spec, rng)]
    scales, seeds = (0.5, 2.0), (0, 4)
    r = netsim.simulate_batch(spec, designs, f, scales=scales, seeds=seeds,
                              cycles=400, warmup=100)
    assert r["throughput"].shape == (2, 2, 2)
    for di, d in enumerate(designs):
        for si, s in enumerate(scales):
            for ki, seed in enumerate(seeds):
                want = netsim.simulate(spec, d, f, inj_scale=s, cycles=400,
                                       warmup=100, seed=seed)
                _assert_same_result({k: v[di, si, ki] for k, v in r.items()},
                                    want)


def test_zero_traffic_returns_idle_network():
    spec = spec_tiny()
    z = np.zeros((spec.n_tiles, spec.n_tiles))
    for fn in (netsim.simulate, netsim.simulate_reference):
        r = fn(spec, spec.mesh_design(), z, cycles=300, warmup=50)
        assert r["delivered"] == 0
        assert r["offered"] == 0.0
        assert r["throughput"] == 0.0
        assert np.isinf(r["mean_latency"]) and np.isinf(r["p99_latency"])


def test_host_tables_match_the_device_routing_tables():
    """The simulator's numpy next-hop tables are the tables the evaluator
    builds on a device (here the CPU: the plain versions of K1 and the
    next-hop extraction), bit for bit."""
    rng = np.random.default_rng(11)
    for spec in (spec_tiny(), spec_16()):
        c = make_consts(spec, "cpu")
        for d in (spec.mesh_design(), random_design(spec, rng)):
            cost = design_cost(c, torch.as_tensor(d.adj)[None])
            dist, nh = routing.routing_tables_batched(cost, c.apsp_iters)
            tab = netsim._design_tables(spec, d)
            np.testing.assert_array_equal(tab["nh"], nh[0].numpy())
            np.testing.assert_array_equal(
                tab["reach"], dist[0].numpy() < netsim.INF / 2)
            np.testing.assert_array_equal(
                tab["nh"], ref_netsim._design_tables(spec, d)["nh"])


def test_disconnected_design_raises_instead_of_corrupting():
    spec = spec_tiny()
    f = traffic_matrix(spec, "BP")
    d = spec.mesh_design()
    d.adj[:] = False  # only vertical links remain: disjoint column pairs
    with pytest.raises(ValueError, match="disconnected"):
        netsim.simulate(spec, d, f, cycles=100, warmup=20)


def test_next_hop_tables_are_cached_per_spec_design():
    spec = spec_tiny()
    f = traffic_matrix(spec, "BP")
    d = spec.mesh_design()
    netsim.clear_caches()
    nh1 = netsim._next_hops(spec, d)
    netsim.saturation_throughput(spec, d, f, cycles=200)
    netsim.simulated_edp(spec, d, f, energy=1.0, cycles=200)
    assert netsim._next_hops(spec, d) is nh1
    assert len(netsim._NH_CACHE) == 1
    netsim._next_hops(spec, random_design(spec, np.random.default_rng(0)))
    assert len(netsim._NH_CACHE) == 2


def test_low_load_delivers_offered_traffic():
    spec = spec_tiny()
    f = traffic_matrix(spec, "BP")
    r = netsim.simulate(spec, spec.mesh_design(), f, inj_scale=0.2,
                        cycles=2000, warmup=400, seed=0)
    assert r["throughput"] == pytest.approx(r["offered"], rel=0.25)
    assert np.isfinite(r["mean_latency"])
    assert r["mean_latency"] >= spec.router_stages


def test_saturation_throughput_below_offered():
    spec = spec_tiny()
    f = traffic_matrix(spec, "BP")
    st = netsim.saturation_throughput(spec, spec.mesh_design(), f, cycles=800)
    assert 0 < st < 32.0


def test_fig4_direction_lower_util_higher_throughput():
    """Designs with clearly lower (U-bar, sigma) should not have clearly
    worse saturation throughput — the Fig. 4 inverse relation, with the
    port's evaluator on the CPU."""
    spec = spec_16()
    f = traffic_matrix(spec, "BFS")
    ev = Evaluator(spec, f, device="cpu")
    rng = np.random.default_rng(1)
    designs = [spec.mesh_design()] + [random_design(spec, rng)
                                      for _ in range(6)]
    objs = ev.batch(designs)
    ok = np.isfinite(objs).all(axis=1)
    designs = [d for d, o in zip(designs, ok) if o]
    objs = objs[ok]
    score = objs[:, 0] + objs[:, 1]
    ths = netsim.saturation_throughput_batch(spec, designs, f,
                                             scales=(8.0, 16.0), cycles=900)
    a = np.argsort(np.argsort(-score))
    b = np.argsort(np.argsort(ths))
    n = len(ths)
    rho = 1 - 6 * np.sum((a - b) ** 2) / (n * (n ** 2 - 1))
    assert rho > 0.0


def test_nh_cache_is_byte_bounded(monkeypatch):
    spec = spec_tiny()
    netsim.clear_caches()
    e0 = netsim._design_tables(spec, spec.mesh_design())
    assert netsim._nh_cache_nbytes == e0["nbytes"] > 0
    monkeypatch.setattr(netsim, "_NH_CACHE_MAX_BYTES", e0["nbytes"])
    e1 = netsim._design_tables(spec, random_design(
        spec, np.random.default_rng(1)))
    assert len(netsim._NH_CACHE) == 1
    assert netsim._nh_cache_nbytes == e1["nbytes"]
    monkeypatch.setattr(netsim, "_NH_CACHE_MAX_BYTES", 0)
    e2 = netsim._design_tables(spec, random_design(
        spec, np.random.default_rng(2)))
    assert len(netsim._NH_CACHE) == 1
    assert netsim._nh_cache_nbytes == e2["nbytes"]
    netsim.clear_caches()
    assert netsim._nh_cache_nbytes == 0 and len(netsim._NH_CACHE) == 0
