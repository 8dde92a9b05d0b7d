"""Kernels of the port on the card: each against its plain version on the
same CUDA tensors, the evaluator on the card against the CPU, the two
device twins (NSGA-II rank/crowding, batched PHV) on the card against the
host, the multi-start search on the card against the CPU, the trace link
report's K4 against its plain version, the smoke-size hybrid served on
the card against the CPU, and the fleet (``stage_dist``): the ``cuda``
executor against ``serial`` and an interrupted run resumed, both byte for
byte.

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
