"""Kernels of the port on the card: each against its plain version on the
same CUDA tensors, and the evaluator on the card against the CPU.

Marked ``cuda``: without a card every test skips (decided inside the
fixture, never at import). On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import routing
from repro_torch.core.evaluate import Evaluator
from repro_torch.core.features import design_features_batch
from repro_torch.core.forest import RegressionForest
from repro_torch.core.objectives import design_cost, make_consts
from repro_torch.core.problem import random_design, spec_16, spec_64
from repro_torch.core.traffic import traffic_matrix
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tables(spec, dev, n=8, seed=0):
    rng = np.random.default_rng(seed)
    designs = [spec.mesh_design()] + [random_design(spec, rng)
                                      for _ in range(n - 1)]
    c = make_consts(spec, "cuda")
    adj = torch.as_tensor(np.stack([d.adj for d in designs]), device=dev)
    cost = design_cost(c, adj)
    dist, nh = routing.routing_tables_batched(cost, c.apsp_iters)
    perm = torch.as_tensor(np.stack([d.perm for d in designs]).astype(
        np.int64), device=dev)
    return c, cost, dist, nh, perm


@pytest.mark.parametrize("n", [7, 33, 129, 300])
def test_minplus_bit_equal_plain(dev, n):
    rng = np.random.default_rng(n)
    a = rng.integers(1, 20, size=(3, n, n)).astype(np.float32)
    a[rng.random(a.shape) > 0.3] = 1e9
    at = torch.as_tensor(a, device=dev)
    assert torch.equal(ops.minplus(at, at), ref.minplus_ref(at, at))


def test_apsp_and_next_hop_bit_equal_host(dev):
    spec = spec_64()
    c, cost, dist, nh, _ = _tables(spec, dev)
    for i in range(cost.shape[0]):
        d_np = routing.apsp_np(cost[i].cpu().numpy(), c.apsp_iters)
        assert np.array_equal(dist[i].cpu().numpy(), d_np)
        assert np.array_equal(nh[i].cpu().numpy(),
                              routing.next_hop_np(cost[i].cpu().numpy(), d_np))


def test_walk_bit_equal_cpu_plain(dev):
    spec = spec_16()
    c, _, _, nh, perm = _tables(spec, dev)
    f = torch.as_tensor(traffic_matrix(spec, "BFS").astype(np.float32),
                        device=dev)
    fs = (f[perm[:, :, None], perm[:, None, :]] * (~c.eye).float()).contiguous()
    got = ops.walk(nh, fs, c.link_delay, spec.max_hops)
    cpu = ref.walk_ref(nh.cpu(), fs.cpu(), c.link_delay.cpu(), spec.max_hops)
    for a, b in zip(got, cpu):
        assert torch.equal(a.cpu(), b)


def test_forest_and_score_against_plain(dev):
    spec = spec_16()
    rng = np.random.default_rng(1)
    x = design_features_batch(spec, [random_design(spec, rng)
                                     for _ in range(200)])
    y = x[:, 0] + rng.normal(size=200)
    forest = RegressionForest(seed=0, device="cuda").fit(x, y)
    nodes = forest.device_nodes()
    depth = forest._flat["depth"]
    xn = torch.as_tensor(forest._normalize(x).astype(np.float32), device=dev)
    got = ops.forest_predict(*nodes, xn, depth)
    assert float((got - ref.forest_predict_ref(*nodes, xn, depth)).abs()
                 .max()) <= 1e-6
    xr = torch.as_tensor(x[:48].astype(np.float32), device=dev)
    xm = torch.as_tensor(forest._xm.astype(np.float32), device=dev)
    xs = torch.as_tensor(forest._xs.astype(np.float32), device=dev)
    v, j = ops.score_block_max(*nodes, xm, xs, xr, 40, depth)
    pv, pj = ref.score_block_max_ref(*nodes, xm, xs, xr, 40, depth)
    assert int(j) == int(pj) and abs(float(v) - float(pv)) <= 1e-6


def test_evaluator_card_matches_cpu(dev):
    spec = spec_64()
    f = traffic_matrix(spec, "BFS")
    rng = np.random.default_rng(2)
    designs = [random_design(spec, rng) for _ in range(12)]
    before = ops.launches()
    gpu = Evaluator(spec, f, device="cuda").batch(designs)
    after = ops.launches()
    assert after["minplus"] > before["minplus"]
    assert after["walk"] == before["walk"] + 1
    cpu = Evaluator(spec, f, device="cpu").batch(designs)
    np.testing.assert_allclose(gpu, cpu, rtol=1e-5, atol=0)
