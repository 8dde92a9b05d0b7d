"""Kernels of the port on the card: each against its plain version on the
same CUDA tensors, the evaluator on the card against the CPU, and the
smoke-size hybrid served on the card against the CPU.

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
from repro_torch.core.problem import (random_design, spec_16, spec_64,
                                      spec_large)
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


@pytest.mark.parametrize("diag", ["zero", "none"])
@pytest.mark.parametrize("n", [7, 33, 64, 129, 300])
def test_apsp_kernel_bit_equal_plain(dev, n, diag):
    """One launch per APSP up to N = 128 (early exit per design), one per
    squaring above; bit-equal to the plain loop either way, also without a
    zero diagonal."""
    rng = np.random.default_rng(n)
    a = rng.integers(1, 20, size=(3, n, n)).astype(np.float32)
    a[rng.random(a.shape) > 4.0 / n] = 1e9
    if diag == "zero":
        a[:, np.arange(n), np.arange(n)] = 0.0
    at = torch.as_tensor(a, device=dev)
    iters = routing.apsp_iters(n)
    n0 = ops.KERNELS["minplus"].launches
    got = ops.apsp(at, iters)
    launched = ops.KERNELS["minplus"].launches - n0
    assert launched == (1 if n <= ops.APSP_MAX_N else iters)
    want = ref.apsp_ref(at, iters)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got, ops.apsp(at, iters))


def test_apsp_and_next_hop_bit_equal_host(dev):
    spec = spec_64()
    c, cost, dist, nh, _ = _tables(spec, dev)
    for i in range(cost.shape[0]):
        d_np = routing.apsp_np(cost[i].cpu().numpy(), c.apsp_iters)
        assert np.array_equal(dist[i].cpu().numpy(), d_np)
        assert np.array_equal(nh[i].cpu().numpy(),
                              routing.next_hop_np(cost[i].cpu().numpy(), d_np))


@pytest.mark.parametrize("spec_fn", [spec_16, spec_64, spec_large])
def test_walk_bit_equal_cpu_plain(dev, spec_fn):
    """K4 twice bit-identical and bit-equal to the CPU plain version, at
    spec_16, spec_64 and spec_large (N = 256, max_hops 48); one counted
    call per walk."""
    spec = spec_fn()
    c, _, _, nh, perm = _tables(spec, dev)
    f = torch.as_tensor(traffic_matrix(spec, "BFS").astype(np.float32),
                        device=dev)
    fs = (f[perm[:, :, None], perm[:, None, :]] * (~c.eye).float()).contiguous()
    n0 = ops.KERNELS["walk"].launches
    got = ops.walk(nh, fs, c.link_delay, spec.max_hops)
    assert ops.KERNELS["walk"].launches == n0 + 1
    again = ops.walk(nh, fs, c.link_delay, spec.max_hops)
    cpu = ref.walk_ref(nh.cpu(), fs.cpu(), c.link_delay.cpu(), spec.max_hops)
    for a, b, w in zip(got, again, cpu):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), w)


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
    assert after["minplus"] == before["minplus"] + 1
    assert after["walk"] == before["walk"] + 1
    cpu = Evaluator(spec, f, device="cpu").batch(designs)
    np.testing.assert_allclose(gpu, cpu, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 2e-5)])
@pytest.mark.parametrize("b,h,kh,s,d,causal,window", [
    (2, 32, 32, 512, 80, True, None),
    (1, 32, 4, 256, 128, True, None),
    (1, 4, 1, 1024, 256, True, 512),
    (2, 4, 2, 333, 16, False, None),
    (2, 8, 2, 333, 80, True, None),
    (1, 4, 4, 200, 32, False, None),
    (1, 2, 1, 100, 20, True, None),       # D % 8 != 0: plain tile loads
])
def test_attention_kernel_against_plain(dev, dtype, tol, b, h, kh, s, d,
                                        causal, window):
    g = torch.Generator(device=dev).manual_seed(s + d)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((b, h, s, d), (b, kh, s, d), (b, kh, s, d)))
    n0 = ops.KERNELS["flash_attention"].launches
    got = ops.attention(q, k, v, causal=causal, window=window)
    assert ops.KERNELS["flash_attention"].launches == n0 + 1
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert torch.equal(got, ops.attention(q, k, v, causal=causal,
                                          window=window))


def test_attention_kernel_refuses_wide_heads(dev):
    q = torch.zeros((1, 1, 4, 264), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        ops.attention(q, q, q)


@pytest.mark.parametrize("b,s,h,p,n", [(2, 512, 80, 64, 64),
                                       (2, 300, 4, 64, 128),
                                       (2, 40, 4, 32, 16),
                                       (2, 128, 7, 64, 64),
                                       (2, 150, 5, 64, 128),
                                       (2, 200, 8, 64, 16),
                                       (1, 100, 3, 30, 10)])
def test_ssd_kernel_against_plain(dev, b, s, h, p, n):
    g = torch.Generator(device=dev).manual_seed(s)
    x = torch.randn((b, s, h, p), generator=g, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=g, device=dev)) * 0.1
    a = -torch.exp(torch.randn(h, generator=g, device=dev) * 0.3)
    bm, cm = (torch.randn((b, s, n), generator=g, device=dev) * 0.5
              for _ in range(2))
    d = torch.full((h,), 0.5, device=dev)
    chunk = min(64, s)
    y, st = ops.ssd(x, dt, a, bm, cm, d, chunk=chunk, return_state=True)
    wy, wst = ref.ssd_padded_ref(x, dt, a, bm, cm, d, chunk=chunk,
                                 return_state=True)
    assert float((y - wy).abs().max()) <= 2e-4
    assert float((st - wst).abs().max()) <= 2e-4
    y2, st2 = ops.ssd(x, dt, a, bm, cm, d, chunk=chunk, return_state=True)
    assert torch.equal(y, y2) and torch.equal(st, st2)


def test_smoke_hybrid_generates_the_same_tokens_on_card_and_cpu(dev):
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config("zamba2-2.7b", smoke=True).scaled(
        compute_dtype=torch.float32)
    gpu = build(cfg, seed=3, device="cuda")
    cpu = build(cfg, _to_cpu(gpu.params), device="cpu")
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(2, 70)).astype(np.int32)
    scfg = ServeConfig(max_new_tokens=6, max_len=96)
    before = ops.launches()
    out = Engine(gpu, scfg).generate(prompts)
    after = ops.launches()
    assert after["ssd"] - before["ssd"] == cfg.n_layers
    assert (after["flash_attention"] - before["flash_attention"]
            == cfg.n_layers // cfg.attn_every)
    np.testing.assert_array_equal(out, Engine(cpu, scfg).generate(prompts))


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}
