"""Kernels of the port on the card: each against its plain version on the
same CUDA tensors, the evaluator on the card against the CPU, the two
device twins (NSGA-II rank/crowding, batched PHV) on the card against the
host, the NSGA-II selection kernel against its plain twin on the card bit
for bit (alone and inside a spec64 search), the multi-start search on the card against the CPU, the trace link
report's K4 against its plain version, the smoke-size hybrid served on
the card against the CPU, the MoE FFN and whisper's smoke config on the
card against the CPU, the fleet (``stage_dist``): the ``cuda``
executor against ``serial`` and an interrupted run resumed, both byte for
byte; and training: the K5/K6 autograd Functions against autograd through
the plain versions, and smoke-size train steps on the card against the
CPU; the smoke configs of the five architectures phase 15 of
chip_smoke.py brought to the card served on the card against the CPU;
no host sync in ``attn_decode``, a whole ``decode_step`` of every family,
an evaluator's device pass and a meta step's; the evaluator's replayed
CUDA graphs (rows bit-equal to the eager pass's, another traffic matrix
on the same graph, two threads at once, launch counts, kernel names in
the profiler's trace); and K3 refusing a side stream.

Marked ``cuda``: without a card every test skips (decided inside the
fixture, never at import). On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import routing
from repro_torch.core.evaluate import Evaluator
from repro_torch.core.features import design_features_batch
from repro_torch.core.forest import RegressionForest
from repro_torch.core.objectives import (design_cost, evaluate_with_tables,
                                         make_consts)
from repro_torch.core.problem import (random_design, spec_16, spec_36,
                                      spec_64, spec_large)
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


def test_walk_plain_version_on_card_is_the_cpu_plain_version(dev):
    """The plain walk on the card sums its flows in index order, as on the
    CPU (no atomics' order): twice bit-identical and bit-equal to the CPU
    at spec_large (N = 256, up to 255 addends per router)."""
    spec = spec_large()
    c, _, _, nh, perm = _tables(spec, dev)
    f = torch.as_tensor(traffic_matrix(spec, "BFS").astype(np.float32),
                        device=dev)
    fs = (f[perm[:, :, None], perm[:, None, :]] * (~c.eye).float()).contiguous()
    one = ref.walk_ref(nh, fs, c.link_delay, spec.max_hops)
    two = ref.walk_ref(nh, fs, c.link_delay, spec.max_hops)
    cpu = ref.walk_ref(nh.cpu(), fs.cpu(), c.link_delay.cpu(), spec.max_hops)
    for a, b, w in zip(one, two, cpu):
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


#: K2/K3 forests (fit kwargs, rows fitted on): the phase-6 forest (24
#: trees, depth 9), one tree, 10 trees (not a multiple of the cluster of
#: 8), depth 0, and one deep enough to take the L2 route.
K23_FORESTS = {
    "t24": (dict(), 400),
    "t1": (dict(n_trees=1), 400),
    "t10": (dict(n_trees=10), 400),
    "depth0": (dict(max_depth=0), 400),
    "l2": (dict(max_depth=16, min_leaf=1), 6000),
}
_k23_cache: dict = {}


def _k23(name: str):
    """(packed forest on the card, spec_64 features of 6000 designs)."""
    if "x" not in _k23_cache:
        rng = np.random.default_rng(11)
        spec = spec_64()
        _k23_cache["x"] = design_features_batch(
            spec, [random_design(spec, rng) for _ in range(6000)])
    x = _k23_cache["x"]
    if name not in _k23_cache:
        kw, n = K23_FORESTS[name]
        y = x[:n, 0] + np.random.default_rng(12).normal(size=n)
        forest = RegressionForest(seed=0, device="cuda", **kw).fit(x[:n],
                                                                    y)
        _k23_cache[name] = forest
    return _k23_cache[name], x


@pytest.mark.parametrize("bsz", [1, 7, 48, 128, 1500])
@pytest.mark.parametrize("name", sorted(K23_FORESTS))
def test_forest_kernels_bit_equal_plain(dev, name, bsz):
    """K2 and K3 bit-equal to their plain versions on the card, one launch
    per call; the route follows the forest's size."""
    forest, x_all = _k23(name)
    pf = forest.packed()
    assert pf.route == ("l2" if name == "l2" else "smem")
    rng = np.random.default_rng(bsz)
    xq = x_all[rng.integers(0, x_all.shape[0], size=bsz)]
    xn = torch.as_tensor(forest._normalize(xq).astype(np.float32),
                         device=dev)
    n0 = ops.KERNELS["forest_predict"].launches
    got = ops.forest_predict_packed(pf, xn)
    assert ops.KERNELS["forest_predict"].launches == n0 + 1
    assert torch.equal(got, ref.forest_predict_ref(*pf.plain, xn, pf.depth))
    x = torch.as_tensor(xq.astype(np.float32), device=dev)
    xm = torch.as_tensor(forest._xm.astype(np.float32), device=dev)
    xs = torch.as_tensor(forest._xs.astype(np.float32), device=dev)
    out = torch.empty(2, dtype=torch.int32, device=dev)
    for n_real in sorted({1, max(1, bsz - 5), bsz}):
        n0 = ops.KERNELS["score_block_max"].launches
        ops.score_block_max_packed(pf, xm, xs, x, n_real, out)
        assert ops.KERNELS["score_block_max"].launches == n0 + 1
        v, j = ref.score_block_max_ref(*pf.plain, xm, xs, x, n_real,
                                       pf.depth)
        assert int(out[1]) == int(j)
        assert int(out[0]) == int(v.view(torch.int32))


@pytest.mark.parametrize("rows", [(63, 64), (127, 128), (10, 130),
                                  (64, 65, 199), (1499, 1400, 700)])
def test_score_block_max_ties_keep_the_first_row(dev, rows):
    """Equal features at rows across lane, block and cluster edges: the
    kernel's argmax is the first of them, as torch.argmax."""
    forest, x_all = _k23("t24")
    pf = forest.packed()
    bsz = 1500 if max(rows) >= 200 else 200
    x = torch.as_tensor(x_all[:bsz].astype(np.float32), device=dev)
    xm = torch.as_tensor(forest._xm.astype(np.float32), device=dev)
    xs = torch.as_tensor(forest._xs.astype(np.float32), device=dev)
    vals = ref.forest_predict_ref(*pf.plain, (x - xm) / xs, pf.depth)
    j0 = int(torch.argmax(vals))
    for r in rows:
        x[r] = x[j0]
    x[j0] = x[(j0 + 1) % bsz] if j0 < min(rows) else x[j0]
    vals = ref.forest_predict_ref(*pf.plain, (x - xm) / xs, pf.depth)
    first = int(torch.nonzero(vals == vals.max())[0])
    out = torch.empty(2, dtype=torch.int32, device=dev)
    ops.score_block_max_packed(pf, xm, xs, x, bsz, out)
    assert int(out[1]) == first
    assert int(out[0]) == int(vals[first].view(torch.int32))


@pytest.mark.parametrize("bsz", [48, 1500])
def test_forest_kernels_ten_calls_bit_identical(dev, bsz):
    """Ten back-to-back launches on one stream give the same bits: K3's
    fold counter resets itself."""
    forest, x_all = _k23("t24")
    pf = forest.packed()
    x = torch.as_tensor(x_all[:bsz].astype(np.float32), device=dev)
    xm = torch.as_tensor(forest._xm.astype(np.float32), device=dev)
    xs = torch.as_tensor(forest._xs.astype(np.float32), device=dev)
    outs = [ops.score_block_max_packed(
        pf, xm, xs, x, bsz, torch.empty(2, dtype=torch.int32, device=dev))
        for _ in range(10)]
    preds = [ops.forest_predict_packed(pf, (x - xm) / xs) for _ in range(10)]
    for o, p in zip(outs[1:], preds[1:]):
        assert torch.equal(o, outs[0]) and torch.equal(p, preds[0])


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
    (8, 32, 4, 512, 128, True, None),     # qwen3-moe prefill
    (8, 8, 8, 1500, 64, False, None),     # whisper-base encoder
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
    from repro_torch.dist.sharding import Policy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config("zamba2-2.7b", smoke=True).scaled(
        compute_dtype=torch.float32)
    gpu = build(cfg, seed=3, device="cuda")
    cpu = build(cfg, _to_cpu(gpu.params), device="cpu")
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(2, 70)).astype(np.int32)
    scfg = ServeConfig(max_new_tokens=6, max_len=96)
    before = ops.launches()
    out = Engine(gpu, make_host_mesh(), Policy(), None, scfg).generate(
        prompts)
    after = ops.launches()
    assert after["ssd"] - before["ssd"] == cfg.n_layers
    assert (after["flash_attention"] - before["flash_attention"]
            == cfg.n_layers // cfg.attn_every)
    np.testing.assert_array_equal(out, Engine(
        cpu, make_host_mesh(), Policy(), None, scfg).generate(prompts))


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


@pytest.mark.parametrize("t", [16, 1100])
def test_moe_ffn_on_card_matches_cpu(dev, t):
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("qwen3-moe-30b-a3b", smoke=True).scaled(
        compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(t)
    p = moe.init_moe_layer(cfg, gen)
    x = torch.randn((1, t, cfg.d_model), generator=gen)
    y, aux = moe.moe_ffn(cfg, p, x)
    gy, gaux = moe.moe_ffn(cfg, {k: v.to(dev) for k, v in p.items()},
                           x.to(dev))
    np.testing.assert_allclose(gy.cpu().numpy(), y.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert abs(gaux.item() - aux.item()) <= 1e-6


def test_smoke_whisper_generates_the_same_tokens_on_card_and_cpu(dev):
    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = get_config("whisper-base", smoke=True).scaled(
        compute_dtype=torch.float32)
    gpu = build(cfg, seed=3, device="cuda")
    cpu = build(cfg, _to_cpu(gpu.params), device="cpu")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (2, 150, cfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 8)))
    outs = []
    for model in (gpu, cpu):
        before = ops.launches()["flash_attention"]
        logits, cache = model.prefill(frames, tokens, 16)
        assert (ops.launches()["flash_attention"] - before
                == (cfg.encoder_layers if model is gpu else 0))
        toks = []
        for _ in range(6):
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            toks.append(tok.cpu())
            logits, cache = model.decode_step(cache, tok)
        outs.append(torch.cat(toks, 1).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_rank_twin_on_card_matches_numpy(dev):
    from repro_torch.core.nsga2 import rank_and_crowding

    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(2, 65))
        m = int(rng.integers(1, 5))
        objs = rng.integers(0, 4, size=(n, m)).astype(np.float64)
        r_np, c_np = rank_and_crowding(objs, "numpy")
        r_d, c_d = rank_and_crowding(objs, "device", device=dev)
        assert np.array_equal(r_np, r_d)
        fin = np.isfinite(c_np)
        assert np.array_equal(fin, np.isfinite(c_d))
        np.testing.assert_allclose(c_d[fin], c_np[fin], rtol=1e-5, atol=1e-6)


def _twin_packed(x):
    """The plain twin on ``x``'s device, packed as the kernel's output."""
    rank, crowd = ref.nsga2_rank_ref(x)
    return torch.stack((rank, crowd.view(torch.int32)))


def _assert_kernel_bit_equal_twin(x, label):
    got = ops.nsga2_rank(x)
    want = _twin_packed(x)
    assert torch.equal(got[0], want[0]), label
    # The crowding's f32 bits: inf and NaN positions (and payloads) too.
    assert np.array_equal(got[1].cpu().numpy(), want[1].cpu().numpy()), label


@pytest.mark.parametrize("n", [1, 2, 3, 31, 32, 33, 64, 65, 257, 1024, 2000])
def test_nsga2_rank_kernel_bit_equal_plain(dev, n):
    """The selection kernel against the plain twin on the card, m = 1..5:
    rows of small integers (duplicate rows, column ties), some rows all
    inf, some cells inf (inf - inf makes NaN crowding). n = 1024 and 2000
    take the global workspace; one launch a call."""
    rng = np.random.default_rng(n)
    before = ops.launches()["nsga2_rank"]
    calls = 0
    for m in range(1, 6):
        ints = rng.integers(0, 4, size=(n, m)).astype(np.float32)
        inf_rows = ints.copy()
        inf_rows[rng.random(n) < 0.2] = np.inf
        inf_cells = ints.copy()
        inf_cells[rng.random((n, m)) < 0.1] = np.inf
        for kind, objs in (("ints", ints), ("inf rows", inf_rows),
                           ("inf cells", inf_cells)):
            _assert_kernel_bit_equal_twin(torch.as_tensor(objs, device=dev),
                                          (n, m, kind))
            calls += 1
    assert ops.launches()["nsga2_rank"] - before == calls


@pytest.fixture(scope="module")
def nsga2_spec64():
    """Two short NSGA-II searches on spec64/BFS on the card (pop 32, 300
    evaluations): selection through the kernel, and through the plain twin
    on the card; each with the rows of every selection call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.noc import Budget, NocProblem, named_spec, run

    problem = NocProblem(spec=named_spec("64"), traffic="BFS", case="case5")
    runs = {}
    for name, fn in (("kernel", ops.nsga2_rank), ("twin", _twin_packed)):
        seen = []

        def scored(x, fn=fn, seen=seen):
            seen.append(x.cpu())
            return fn(x)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ops, "nsga2_rank", scored)
            res = run(problem, "nsga2", Budget(max_evals=300),
                      config={"pop_size": 32}, device="cuda")
        runs[name] = (res, seen)
    return runs


def test_nsga2_rank_kernel_bit_equal_plain_on_a_search(nsga2_spec64):
    """The population (32) and union (64) matrices of a real spec64/BFS
    search, kernel against the twin on the card."""
    _, seen = nsga2_spec64["kernel"]
    assert {tuple(x.shape) for x in seen} == {(32, 5), (64, 5)}
    for i, x in enumerate(seen):
        _assert_kernel_bit_equal_twin(x.cuda(), (i, tuple(x.shape)))


def test_nsga2_search_same_front_through_kernel_and_twin(nsga2_spec64):
    """Selection through the kernel takes the twin's decisions: the same
    selection inputs call by call, the same front and accounting."""
    (res_k, seen_k), (res_t, seen_t) = (nsga2_spec64["kernel"],
                                        nsga2_spec64["twin"])
    assert len(seen_k) == len(seen_t) > 2
    assert all(torch.equal(a, b) for a, b in zip(seen_k, seen_t))
    assert np.array_equal(res_k.objs, res_t.objs)
    assert (res_k.n_evals, res_k.n_calls) == (res_t.n_evals, res_t.n_calls)


def test_rank_and_crowding_on_card_is_one_copy_in_one_launch_one_copy_out(
        dev):
    """``rank_and_crowding(..., "device")`` on the card: one nsga2_rank
    launch a call and no other kernel, one copy each way (torch.profiler,
    after a throwaway session), the rows all through the kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.nsga2 import rank_and_crowding

    rng = np.random.default_rng(7)
    pops = [rng.random((n, 5)) for n in (32, 64, 32, 64)]
    before = ops.launches()["nsga2_rank"]
    for objs in pops:
        rank_and_crowding(objs, "device", device=dev)
    assert ops.launches()["nsga2_rank"] - before == len(pops)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        rank_and_crowding(pops[0], "device", device=dev)
    with profile(activities=activities) as prof:
        for objs in pops:
            rank_and_crowding(objs, "device", device=dev)
        torch.cuda.synchronize()
    events = prof.events()
    host = {e.name for e in events if e.device_type != DeviceType.CUDA}
    on_card = [e.name for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in host]
    copies = [n for n in on_card if n.startswith("Memcpy")]
    kernels = [n for n in on_card if not n.startswith("Memcpy")]
    assert len(kernels) == len(pops), kernels
    assert all("nsga2_rank_kernel" in n for n in kernels), kernels
    assert len(copies) == 2 * len(pops), copies


def test_the_kernel_counter_counts_every_selection_call(dev):
    """Under ``recording()``, ``noc.nsga2.rank.kernel`` equals the calls of
    the ``noc.nsga2.rank`` span: every selection call took the kernel."""
    from repro_torch import tracing
    from repro_torch.noc import Budget, NocProblem, named_spec, run

    with tracing.recording():
        run(NocProblem(spec=named_spec("16"), traffic="BFS"), "nsga2",
            Budget(max_evals=100), config={"pop_size": 8}, device="cuda")
    rec = tracing.runs()[-1]
    calls = rec["spans"]["noc.nsga2.rank"][0]
    assert calls >= 2
    assert rec["counts"]["noc.nsga2.rank.kernel"] == calls


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_phv_twin_on_card_matches_host(dev, m):
    from repro_torch.core.pareto import hypervolume_with_batch
    from repro_torch.core.phv_torch import hypervolume_with_batch_torch

    rng = np.random.default_rng(m)
    ref = np.full(m, 1.6)
    pts = rng.uniform(0.2, 1.5, size=(9, m))
    pts = np.vstack([pts, pts[:2]])
    cands = rng.uniform(0.1, 1.9, size=(13, m))
    got = hypervolume_with_batch_torch(pts, cands, ref, device=dev)
    np.testing.assert_allclose(got, hypervolume_with_batch(pts, cands, ref),
                               rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stage_batch_card_matches_cpu(dev, seed):
    """spec_tiny multi-start MOO-STAGE (2 starts, 4 local steps, 500
    evaluations) on the card against the CPU: the same front, or a
    knife-edge whose replay on the CPU's rows is the CPU's run."""
    from repro_torch.noc import Budget, NocProblem, named_spec, run
    from repro_torch.noc.parity import hold_runs

    problem = NocProblem(spec=named_spec("tiny"), traffic="BFS",
                         case="case5")
    config = {"n_starts": 2, "max_local_steps": 4}

    def on(ev):
        return run(problem, "stage_batch", Budget(max_evals=500, seed=seed),
                   config=config, ev=ev)

    hold_runs(on, lambda: problem.evaluator(device=dev),
              on, lambda: problem.evaluator(device="cpu"), 1e-5)


def test_trace_link_report_walk_matches_plain_on_card(dev):
    from repro_torch.workloads import (link_walk_inputs, trace_for,
                                       trace_link_report)

    spec = spec_64()
    design = random_design(spec, np.random.default_rng(3))
    trace = trace_for("yi-6b", "serving")
    consts, nh, phases = link_walk_inputs(spec, design, trace, device=dev)
    for _, f in phases:
        # Every output bit-equal to the plain version on the card and on
        # the CPU.
        got = ops.walk(nh, f, consts.link_delay, consts.max_hops)
        want = ref.walk_ref(nh, f, consts.link_delay, consts.max_hops)
        cpu = ref.walk_ref(nh.cpu(), f.cpu(), consts.link_delay.cpu(),
                           consts.max_hops)
        for a, b, w in zip(got, want, cpu):
            assert torch.equal(a, b)
            assert torch.equal(a.cpu(), w)
    before = ops.launches()["walk"]
    card = trace_link_report(spec, design, trace, device=dev)
    assert ops.launches()["walk"] - before == len(trace.phases)
    cpu = trace_link_report(spec, design, trace, device="cpu")
    np.testing.assert_allclose(card["util"], cpu["util"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(card["visits"], cpu["visits"], rtol=1e-5,
                               atol=0)


# --------------------------------------------------------------- the fleet
def _dist_payload(res) -> str:
    """Canonical payload (tests/test_dist.py's): wall clocks zeroed, the
    driver-naming headers left out."""
    import json

    j = res.to_json()
    j["history"] = [[0.0] + row[1:] for row in j["history"]]
    keep = ("problem", "budget", "obj_idx", "designs", "objs", "history",
            "n_evals", "n_calls", "exhausted")
    return json.dumps({k: j[k] for k in keep}, sort_keys=True)


_FLEET = dict(n_workers=4, iters_max=2, n_swaps=4, n_link_moves=4,
              max_local_steps=4)


def test_stage_dist_cuda_executor_matches_serial_on_card(dev):
    from repro_torch.noc import Budget, NocProblem, named_spec, run

    problem = NocProblem(spec=named_spec("tiny"), traffic="BFS")
    budget = Budget(max_evals=400, seed=0)
    ops.reset_launches()
    ser = run(problem, "stage_dist", budget, config=dict(_FLEET))
    launched = ops.launches()
    assert launched["minplus"] > 0 and launched["walk"] > 0
    cud = run(problem, "stage_dist", budget,
              config=dict(_FLEET, executor="cuda"))
    assert _dist_payload(cud) == _dist_payload(ser)
    assert cud.phv() == ser.phv()
    with pytest.raises(ValueError, match="'cuda'"):
        run(problem, "stage_dist", budget, config=dict(_FLEET,
                                                        executor="jax"))


def test_stage_dist_resume_on_card_is_byte_identical(dev, tmp_path):
    from repro_torch.dist import CoordinatorKilled
    from repro_torch.noc import Budget, NocProblem, named_spec, run

    problem = NocProblem(spec=named_spec("tiny"), traffic="BFS")
    budget = Budget(max_evals=300, seed=1)
    cfg = dict(_FLEET, n_workers=2, sync_every=1, iters_max=3)
    ref = run(problem, "stage_dist", budget, config=cfg)
    with pytest.raises(CoordinatorKilled):
        run(problem, "stage_dist", budget, config=dict(cfg, faults=(
            {"kind": "kill_coordinator", "round": 1},)),
            checkpoint_dir=str(tmp_path))
    res = run(problem, "stage_dist", budget, config=cfg,
              checkpoint_dir=str(tmp_path), resume=True)
    assert res.extra["resumed_from_round"] == 1
    assert _dist_payload(res) == _dist_payload(ref)


def test_evaluator_rows_do_not_depend_on_the_batch_on_card(dev):
    """A design's objective rows on the card are the same in a batch of 48,
    in its chunks, alone, and through the ``spmd`` split (four chunks on
    this card, then one per visible card): the tail's sums keep one order
    whatever the batch."""
    spec = spec_64()
    f = traffic_matrix(spec, "BFS")
    designs = [spec.mesh_design()] + [
        random_design(spec, np.random.default_rng(48)) for _ in range(47)]
    ev = Evaluator(spec, f, device="cuda")
    rows, aux = ev.batch_aux(designs)
    for lo, hi in ((0, 12), (12, 24), (24, 25), (25, 48)):
        part, part_aux = ev.batch_aux(designs[lo:hi])
        assert np.array_equal(part, rows[lo:hi])
        assert np.array_equal(part_aux["net_lat"], aux["net_lat"][lo:hi])
    n = torch.cuda.device_count()
    for split in (["cuda:0"] * 4, [f"cuda:{i}" for i in range(n)]):
        got, got_aux = Evaluator(spec, f, device="cuda",
                                 split_devices=split).batch_aux(designs)
        assert np.array_equal(got, rows)
        assert np.array_equal(got_aux["net_lat"], aux["net_lat"])


@pytest.mark.parametrize("case", [(2, 4, 4, 128, 80, True, None),
                                  (2, 8, 2, 200, 64, True, 64)])
def test_attention_fn_on_card_is_the_kernel_forward_and_plain_backward(
        dev, case):
    b, h, kh, s, d, causal, window = case
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               .requires_grad_(True)
               for shape in ((b, h, s, d), (b, kh, s, d), (b, kh, s, d)))
    g = torch.randn((b, h, s, d), generator=gen, device=dev).bfloat16()
    ops.reset_launches()
    out = ops.attention(q, k, v, causal=causal, window=window)
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert ops.launches()["flash_attention"] == 1
    with torch.no_grad():
        assert torch.equal(out, ops.attention(q, k, v, causal=causal,
                                              window=window))
    want = torch.autograd.grad(
        ref.attention_ref(q, k, v, causal=causal, window=window),
        (q, k, v), g)
    for a, w in zip(grads, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("s", [256, 100])
def test_ssd_fn_on_card_is_the_kernel_forward_and_plain_backward(dev, s):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, s, 4, 64), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((2, s, 4), generator=gen, device=dev)) * 0.1
    a = -torch.exp(torch.randn(4, generator=gen, device=dev) * 0.3)
    bm = torch.randn((2, s, 32), generator=gen, device=dev) * 0.5
    cm = torch.randn((2, s, 32), generator=gen, device=dev) * 0.5
    d = torch.full((4,), 0.5, device=dev)
    args = [t.requires_grad_(True) for t in (x, dt, a, bm, cm, d)]
    g = torch.randn(x.shape, generator=gen, device=dev)
    ops.reset_launches()
    out = ops.ssd(*args, chunk=64)
    grads = torch.autograd.grad(out, args, g)
    assert ops.launches()["ssd"] == 1
    want = torch.autograd.grad(ref.ssd_padded_ref(*args, chunk=64), args, g)
    for a_, w in zip(grads, want):
        assert torch.equal(a_, w)


#: The five architectures no card run reached before phase 15 of
#: chip_smoke.py.
FIVE_ARCHS = ["gemma3-1b", "mamba2-1.3b", "chameleon-34b",
              "deepseek-coder-33b", "mistral-large-123b"]


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "yi-6b", *FIVE_ARCHS])
def test_smoke_train_steps_on_card_match_cpu(dev, arch):
    from repro_torch.ckpt.checkpoint import tree_leaves, tree_unflatten
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist.sharding import Policy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_train
    from repro_torch.train import OptConfig, make_train_fns

    cfg = get_config(arch, smoke=True).scaled(compute_dtype=torch.float32)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=4))
    opt = OptConfig(lr=1e-2, warmup_steps=2)
    mesh = make_host_mesh()
    init, _ = make_train_fns(build_train(cfg, device="cpu"), mesh, Policy(),
                             opt)
    state0 = init(0)
    losses = {}
    for device in ("cpu", dev):
        _, step = make_train_fns(build_train(cfg, device=device), mesh,
                                 Policy(), opt)
        state = tree_unflatten(state0, [t.detach().to(device, copy=True)
                                        for t in tree_leaves(state0)])
        for p in tree_leaves(state["params"]):
            p.requires_grad_(True)
        losses[str(device)] = [step(state, data.batch(i))[1]["loss"].item()
                               for i in range(5)]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.parametrize("arch", FIVE_ARCHS)
def test_smoke_generates_the_same_tokens_on_card_and_cpu(dev, arch):
    """Prompts of 70 tokens: past the gemma3 smoke's window of 8, and a
    padded SSD tail for mamba2 (chunk 64)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.dist.sharding import Policy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config(arch, smoke=True).scaled(compute_dtype=torch.float32)
    gpu = build(cfg, seed=3, device=dev)
    cpu = build(cfg, _to_cpu(gpu.params), device="cpu")
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(2, 70)).astype(np.int32)
    scfg = ServeConfig(max_new_tokens=6, max_len=96)
    before = ops.launches()
    out = Engine(gpu, make_host_mesh(), Policy(), None, scfg).generate(
        prompts)
    after = ops.launches()
    ssm = cfg.family == "ssm"
    assert after["ssd"] - before["ssd"] == (cfg.n_layers if ssm else 0)
    assert (after["flash_attention"] - before["flash_attention"]
            == (0 if ssm else cfg.n_layers))
    np.testing.assert_array_equal(out, Engine(
        cpu, make_host_mesh(), Policy(), None, scfg).generate(prompts))


@contextlib.contextmanager
def _no_host_sync():
    """PyTorch's sync debug mode set to raise on any host-device
    synchronisation inside the block."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("window", [0, 8])
def test_attn_decode_makes_no_host_sync(dev, window):
    from repro_torch.configs import get_config
    from repro_torch.models.attention import attn_decode, init_attn_layer

    cfg = get_config("gemma3-1b", smoke=True)
    p = init_attn_layer(cfg, torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((2, 1, cfg.d_model), generator=g, device=dev).to(
        cfg.compute_dtype)
    shape = (2, 32, cfg.n_kv_heads, cfg.resolved_head_dim)
    ck = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    cv = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    attn_decode(cfg, p, x, ck, cv, 20, window=window)
    with _no_host_sync():
        y = attn_decode(cfg, p, x, ck, cv, 21, window=window)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen3-moe-30b-a3b",
                                  "gemma3-1b", "mamba2-1.3b",
                                  "whisper-base"])
def test_decode_step_makes_no_host_sync(dev, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = get_config(arch, smoke=True)
    model = build(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab, (2, 24)), device=dev)
    if cfg.family == "encdec":
        frames = torch.as_tensor(rng.standard_normal(
            (2, 40, cfg.d_model)).astype(np.float32), device=dev)
        logits, cache = model.prefill(frames, tokens, 32)
    else:
        logits, cache = model.prefill(tokens, 32)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    logits, cache = model.decode_step(cache, tok)
    with _no_host_sync():
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        logits, cache = model.decode_step(cache, tok)
    assert cache["pos"] == 26 and bool(torch.isfinite(logits).all())


def test_evaluator_device_pass_makes_no_host_sync(dev):
    """One evaluator call from its designs on the card to its objective
    rows on the card: the cost build, APSP (K1), next hops, the walk (K4)
    and the objectives. Only the upload of the designs and the read-back
    of the rows sync, as the reference's transfers do."""
    spec = spec_64()
    ev = Evaluator(spec, traffic_matrix(spec, "BFS"), device=dev)
    rng = np.random.default_rng(2)
    designs = [random_design(spec, rng) for _ in range(12)]
    want = ev.batch(designs)
    perms = torch.as_tensor(np.stack([d.perm for d in designs]),
                            dtype=torch.int64, device=dev)
    adjs = torch.as_tensor(np.stack([d.adj for d in designs]),
                           dtype=torch.bool, device=dev)
    with _no_host_sync():
        dist, nh = routing.routing_tables_batched(design_cost(ev.consts, adjs),
                                                  ev.consts.apsp_iters)
        objs, _ = evaluate_with_tables(ev.consts, perms, adjs, ev.f, dist, nh)
    np.testing.assert_array_equal(objs.cpu().numpy().astype(np.float64), want)



def _graph_counts(fn):
    """``fn()`` inside a traced record: (its result, the evaluator's
    graph counters)."""
    from repro_torch import tracing

    with tracing.recording(), tracing.span(tracing.ROOT):
        out = fn()
    counts = tracing.runs()[-1]["counts"]
    return out, {k.rsplit(".", 1)[1]: v for k, v in counts.items()
                 if k.startswith("noc.eval.graph.")}


def _eager(ev):
    """``ev`` made to run every chunk eagerly, as before graphs."""
    ev._graphs = False
    return ev


def _eval_case(spec_fn, rows, tables):
    """(spec, traffic, the call to make on an evaluator): ``rows`` designs
    through ``batch_aux``, or with ``tables`` a neighbourhood of ``rows``
    moves through ``batch_moves`` with the delta path on."""
    from repro_torch.core.problem import sample_neighbor_moves

    spec = spec_fn()
    f = traffic_matrix(spec, "BFS")
    rng = np.random.default_rng(rows)
    if tables:
        moves = sample_neighbor_moves(spec, random_design(spec, rng), rng,
                                      rows // 2, rows - rows // 2)
        return spec, f, lambda ev: (ev.batch_moves(moves), {})
    designs = [spec.mesh_design()] + [random_design(spec, rng)
                                      for _ in range(rows - 1)]
    return spec, f, lambda ev: ev.batch_aux(designs)


@pytest.mark.parametrize("spec_fn,rows,tables", [
    (spec_64, 32, False), (spec_64, 48, False), (spec_36, 192, False),
    (spec_large, 8, False), (spec_large, 8, True)])
def test_replayed_rows_are_the_eager_rows_bit_for_bit(dev, spec_fn, rows,
                                                      tables):
    """A chunk shape's first call runs eagerly, its second captures and
    replays, its third replays: each gives the rows (and auxiliary
    outputs) of the eager pass, bit for bit."""
    spec, f, call = _eval_case(spec_fn, rows, tables)
    delta = "on" if tables else "off"
    want, want_aux = call(_eager(Evaluator(spec, f, device=dev,
                                           delta=delta)))
    ev = Evaluator(spec, f, device=dev, delta=delta)
    assert ev.max_batch >= rows
    seen = []
    for _ in range(3):
        (got, aux), counts = _graph_counts(lambda: call(ev))
        seen.append(counts)
        assert np.array_equal(got, want)
        for k in want_aux:
            assert aux[k].dtype == want_aux[k].dtype
            assert np.array_equal(aux[k], want_aux[k])
    # Where an earlier test saw the shape, the sequence starts later.
    stages = [{"eager": 1}, {"eager": 1, "capture": 1}] + [{"replay": 1}] * 3
    assert any(seen == stages[i:i + 3] for i in range(3)), seen


def test_another_traffic_matrix_gets_its_own_rows_from_the_same_graph(dev):
    spec = spec_64()
    rng = np.random.default_rng(5)
    designs = [random_design(spec, rng) for _ in range(24)]
    fa, fb = traffic_matrix(spec, "BFS"), traffic_matrix(spec, "KNN")
    want_a = _eager(Evaluator(spec, fa, device=dev)).batch(designs)
    want_b = _eager(Evaluator(spec, fb, device=dev)).batch(designs)
    assert not np.array_equal(want_a, want_b)
    ea, eb = Evaluator(spec, fa, device=dev), Evaluator(spec, fb, device=dev)
    for _ in range(2):
        ea.batch(designs)
    for ev, want in ((eb, want_b), (ea, want_a), (eb, want_b)):
        got, counts = _graph_counts(lambda: ev.batch(designs))
        assert counts == {"replay": 1} and np.array_equal(got, want)


def test_two_threads_evaluating_at_once_stay_right(dev):
    """Two threads, each with its own evaluator, traffic and chunk shapes,
    capture and replay at once; every call gives its eager rows."""
    import concurrent.futures as cf

    spec = spec_64()
    rng = np.random.default_rng(6)
    jobs = []
    for app, rows in (("BFS", 16), ("KNN", 20)):
        f = traffic_matrix(spec, app)
        designs = [random_design(spec, rng) for _ in range(rows)]
        jobs.append((f, designs,
                     _eager(Evaluator(spec, f, device=dev)).batch(designs)))
    start = threading.Barrier(2)

    def work(job):
        f, designs, want = job
        ev = Evaluator(spec, f, device=dev)
        start.wait()
        return all(np.array_equal(ev.batch(designs), want)
                   for _ in range(20))

    with cf.ThreadPoolExecutor(2) as pool:
        assert list(pool.map(work, jobs)) == [True, True]


def test_a_replayed_call_counts_the_eager_calls_launches(dev):
    """K1 and K4 launches, and the work a work log records, are those of
    an eager call, whether the call ran eagerly, captured or replayed."""
    spec = spec_64()
    rng = np.random.default_rng(8)
    designs = [random_design(spec, rng) for _ in range(40)]
    counts = []
    for ev in [_eager(Evaluator(spec, traffic_matrix(spec, "BFS"),
                                device=dev))] + \
            [Evaluator(spec, traffic_matrix(spec, "BFS"), device=dev)] * 3:
        before, work = ops.launches(), []
        with ops.work_log(work):
            ev.batch(designs)
        after = ops.launches()
        counts.append(({k: after[k] - before[k] for k in after},
                       [(w.kernel, w.flops, w.bytes) for w in work]))
    assert counts[0][0]["minplus"] == counts[0][0]["walk"] == 1
    assert counts[1:] == [counts[0]] * 3


def test_replayed_kernels_reach_the_trace_under_their_names(dev):
    """K1 and K4 replayed from a captured graph appear on the profiler's
    device timeline under their own names, once a replay each: the
    benchmark's rooflines read kernel time by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spec = spec_64()
    rng = np.random.default_rng(9)
    designs = [random_design(spec, rng) for _ in range(44)]
    ev = Evaluator(spec, traffic_matrix(spec, "BFS"), device=dev)
    for _ in range(2):
        ev.batch(designs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (_, counts) = _graph_counts(lambda: [ev.batch(designs)
                                             for _ in range(3)])
        torch.cuda.synchronize()
    assert counts == {"replay": 3}
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    assert sum("apsp_kernel" in n for n in names) == 3
    assert sum("walk_tree_kernel" in n or "walk_util_kernel" in n
               for n in names) == 2 * 3

def _meta_case(dev):
    from repro_torch.core.fused import MetaScorer
    from repro_torch.core.problem import sample_neighbor_moves

    spec = spec_16()
    rng = np.random.default_rng(1)
    designs = [random_design(spec, rng) for _ in range(200)]
    x = design_features_batch(spec, designs)
    forest = RegressionForest(seed=0, device=dev).fit(
        x, x[:, 0] + rng.normal(size=200))
    scorer = MetaScorer(spec, forest, device=dev)
    moves = sample_neighbor_moves(spec, designs[0], rng, 20, 20)
    return scorer, moves


def test_meta_step_device_pass_makes_no_host_sync(dev):
    """One fused meta step from its move arrays on the card: the
    featurization (the link moves' degree update included) and K3. Only
    the upload and K3's 8-byte read-back sync."""
    from repro_torch.core.fused import fused_features

    scorer, moves = _meta_case(dev)
    j, v = scorer.score_moves(moves)
    base_perm, base_lm, scalars = scorer._base_state(moves.base)
    args = [torch.as_tensor(a, device=dev) for a in (
        base_perm, base_lm, *scalars, *scorer._encode(moves))]
    with _no_host_sync():
        feats = fused_features(scorer.c, scorer._h["k"], args[0], args[1],
                               tuple(args[2:7]), *args[7:])
        out = ops.score_block_max_packed(scorer.forest, scorer.xm, scorer.xs,
                                         feats, feats.shape[0],
                                         torch.empty_like(scorer._out))
    assert int(out[1]) == j and float(out.view(torch.float32)[0]) == v


def test_score_block_max_raises_on_a_side_stream(dev):
    """K3's fold counter is one per device: a call on a stream other than
    the default stream raises instead of racing."""
    scorer, moves = _meta_case(dev)
    j, v = scorer.score_moves(moves)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side), pytest.raises(RuntimeError,
                                                match="default stream"):
        scorer.score_moves(moves)
    assert scorer.score_moves(moves) == (j, v)


@pytest.fixture(scope="module")
def stage_spec_large():
    """Two MOO-STAGE searches of 200 evaluations on spec_large (N = 256)
    under BFS on the card, the evaluator's delta path on and off, each
    under ``tracing.recording()``: (result, evaluator, record) by mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import tracing
    from repro_torch.noc import Budget, NocProblem, run

    problem = NocProblem(spec=spec_large(), traffic="BFS", case="case5")
    out = {}
    for delta in ("on", "off"):
        ev = problem.evaluator(device="cuda", delta=delta)
        with tracing.recording():
            res = run(problem, "stage", Budget(max_evals=200, seed=7),
                      {"max_local_steps": 40}, ev=ev, device="cuda")
        out[delta] = (res, ev, tracing.runs()[-1])
    return out


def test_spec_large_search_same_front_with_delta_on_and_off(
        stage_spec_large):
    """At N = 256 the delta path's host tables (swaps' reuse, link moves'
    updates, rebuilds) give the dense path's rows bit for bit: the same
    front and accounting, and counters equal to ``delta_stats``."""
    (on, ev_on, rec_on), (off, ev_off, rec_off) = (stage_spec_large["on"],
                                                   stage_spec_large["off"])
    assert ev_on.max_batch == ev_off.max_batch == 8
    stats = ev_on.delta_stats
    assert stats["swap"] > 0 and stats["delta"] > 0
    assert [d.key() for d in on.designs] == [d.key() for d in off.designs]
    assert np.array_equal(on.objs, off.objs)
    assert (on.n_evals, on.n_calls) == (off.n_evals, off.n_calls)
    counts = rec_on["counts"]
    assert tuple(counts.get(f"noc.delta.{c}", 0) for c in (
        "swap", "link", "fallback", "table_hit", "table_miss")) == (
        stats["swap"], stats["delta"] + stats["fallback"], stats["fallback"],
        stats["table_hits"], stats["table_misses"])
    assert stats["swap"] < counts["noc.delta.served"] <= on.n_evals
    assert {"noc.eval.delta", "noc.eval.rebuild"} <= set(rec_on["spans"])
    assert not {"noc.eval.delta", "noc.eval.rebuild"} & set(rec_off["spans"])
    assert ev_off.delta_stats == dict.fromkeys(stats, 0)


def test_spec_large_dense_call_takes_k1s_per_product_path(dev):
    """An evaluator call at N = 256 (above ``ops.APSP_MAX_N``) runs K1 as
    one min-plus product per squaring, as the profiler counts them, and
    never the one-launch APSP kernel; its rows are the CPU's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spec = spec_large()
    f = traffic_matrix(spec, "BFS")
    rng = np.random.default_rng(11)
    designs = [spec.mesh_design()] + [random_design(spec, rng)
                                      for _ in range(7)]
    ev = Evaluator(spec, f, device="cuda", delta="off")
    assert spec.n_tiles > ops.APSP_MAX_N and ev.max_batch == len(designs)
    ev.batch(designs)                                  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rows = ev.batch(designs)
        torch.cuda.synchronize()
    launches = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            launches[e.key] = launches.get(e.key, 0) + e.count
    minplus = sum(c for k, c in launches.items() if "minplus_kernel" in k)
    assert minplus == routing.apsp_iters(spec.n_tiles)
    assert not [k for k in launches if "apsp_kernel" in k]
    cpu = Evaluator(spec, f, device="cpu", delta="off").batch(designs)
    np.testing.assert_allclose(rows, cpu, rtol=1e-5, atol=0)
