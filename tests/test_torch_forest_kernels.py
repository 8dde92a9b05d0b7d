"""The node records and the orders of kernels K2 and K3 (csrc/forest.cu),
emulated in PyTorch on the CPU and held against the plain versions
(kernels/ref.py) and the JAX reference.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
marker ``cuda``). Here: the packed 16-byte records walk to the plain
version's leaves; the tree split among a cluster's CTAs, with the leader
summing trees ascending, gives the plain mean's bits; the kernel's argmax
(lanes, a shuffle fold, then the clusters in order) keeps torch.argmax's
first max; and MetaScorer returns what the plain tail returns."""

import math

import numpy as np
import pytest
import torch

from repro.core.forest import RegressionForest as RefForest
from repro.core.problem import spec_16, spec_64, spec_tiny
from repro_torch.convert import forest_from_flat
from repro_torch.core.features import design_features_batch
from repro_torch.core.forest import RegressionForest
from repro_torch.core.fused import MetaScorer, fused_features
from repro_torch.core.problem import random_design, sample_neighbor_moves
from repro_torch.kernels import ops, ref


def complete_forest(t: int, depths, f: int, seed: int = 0) -> dict:
    """A flat forest of complete binary trees (tree i of depth
    ``depths[i % len(depths)]``, children 2i+1 and 2i+2, leaves
    self-looping), padded to the largest tree; random features,
    thresholds and values from ``seed``."""
    rng = np.random.default_rng(seed)
    ds = [depths[i % len(depths)] for i in range(t)]
    m = 2 ** (max(ds) + 1) - 1
    feature = np.full((t, m), -1, np.int32)
    left = np.tile(np.arange(m, dtype=np.int32), (t, 1))
    right = left.copy()
    for i, d in enumerate(ds):
        inner = 2 ** d - 1
        feature[i, :inner] = rng.integers(0, f, size=inner)
        left[i, :inner] = 2 * np.arange(inner) + 1
        right[i, :inner] = 2 * np.arange(inner) + 2
    return {"feature": feature, "threshold": rng.normal(size=(t, m)),
            "left": left, "right": right, "value": rng.normal(size=(t, m)),
            "depth": max(ds), "n_nodes": m}


def port_forest(flat: dict, f: int) -> RegressionForest:
    return forest_from_flat(flat, np.zeros(f), np.ones(f), device="cpu")


def fitted_forest(n_trees, max_depth, n=200, f=5, seed=0, **kw):
    """A reference forest fitted from ``seed``, its port twin, and rng."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, f))
    y = x[:, 0] * 2 + np.sin(3 * x[:, 1]) + 0.1 * rng.normal(size=n)
    model = RefForest(seed=seed, n_trees=n_trees, max_depth=max_depth,
                      **kw).fit(x, y)
    port = forest_from_flat(model._flat, model._xm, model._xs, device="cpu")
    return model, port, rng


def walk_records(pf: ops.PackedForest, x: torch.Tensor) -> torch.Tensor:
    """(T, B) leaves by the kernel's walk: per level one record (threshold
    bits, feature, left, right), right on a strict ``x[feature] > thr``."""
    t, b = pf.n_trees, x.shape[0]
    tix = torch.arange(t)[:, None].expand(t, b)
    bix = torch.arange(b)[None, :].expand(t, b)
    idx = torch.zeros((t, b), dtype=torch.long)
    for _ in range(pf.depth):
        r = pf.records[tix, idx]
        thr = r[..., 0].contiguous().view(torch.float32)
        xv = x[bix, r[..., 1].long()]
        idx = torch.where(xv > thr, r[..., 3], r[..., 2]).long()
    return idx


def cluster_mean(pf: ops.PackedForest, x: torch.Tensor) -> torch.Tensor:
    """(B,) tree means in the kernel's order: CTA r of the cluster writes
    the leaf values of its trees into the leader's (T, B) array, the leader
    sums trees ascending in f32 and divides by T."""
    t = pf.n_trees
    leaves = walk_records(pf, x)
    lead = torch.full((t, x.shape[0]), float("nan"))
    for rank in range(pf.cluster):
        t0, t1 = ops.tree_slice(t, pf.cluster, rank)
        for tree in range(t0, t1):
            lead[tree] = pf.value[tree, leaves[tree]]
    acc = torch.zeros(x.shape[0])
    for tree in range(t):
        acc = acc + lead[tree]
    return acc / torch.full_like(acc, t)


def kernel_argmax(vals: list[float], n_real: int,
                  block_rows: int = ops.FOREST_BLOCK_ROWS):
    """The kernel's (max, first argmax) over rows < ``n_real``: per block
    of rows, 32 lanes scan their rows ascending with a strict '>', then
    fold by ``__shfl_down`` (a tie going to the lower row); the blocks'
    partials fold in block order with a strict '>'."""
    parts = []
    for row0 in range(0, n_real, block_rows):
        nrows = min(block_rows, n_real - row0)
        lanes = []
        for lane in range(32):
            best, arg = ((vals[row0 + lane], row0 + lane) if lane < nrows
                         else (-math.inf, 2 ** 31 - 1))
            for s in range(lane + 32, nrows, 32):
                if vals[row0 + s] > best:
                    best, arg = vals[row0 + s], row0 + s
            lanes.append((best, arg))
        off = 16
        while off:
            nxt = []
            for lane in range(32):
                b, a = lanes[lane]
                ob, oa = lanes[lane + off] if lane + off < 32 else (b, a)
                nxt.append((ob, oa) if ob > b or (ob == b and oa < a)
                           else (b, a))
            lanes = nxt
            off //= 2
        parts.append(lanes[0])
    best, arg = parts[0]
    for v, a in parts[1:]:
        if v > best:
            best, arg = v, a
    return best, arg


FOREST_SHAPES = {
    "fitted": dict(n_trees=10, max_depth=7, n=300, f=6),
    "one_tree": dict(n_trees=1, max_depth=6, n=120, f=4),
    "depth0": dict(n_trees=5, max_depth=0, n=100, f=3),
    "deepest": dict(n_trees=6, max_depth=16, n=256, f=4, min_leaf=1),
    "ragged": dict(n_trees=12, max_depth=6, n=60, f=5, min_leaf=1),
    "t24": dict(n_trees=24, max_depth=9, n=400, f=6),
}


@pytest.mark.parametrize("batch", [1, 7, 130])
@pytest.mark.parametrize("shape", sorted(FOREST_SHAPES))
def test_packed_records_walk_to_plain_leaves(shape, batch):
    """The packed records, walked as the kernel walks them, reach the plain
    version's leaves bit for bit; their leaf values are the plain ones and
    the mean is within 1e-6 of the reference's f64 numpy oracle."""
    kw = dict(FOREST_SHAPES[shape])
    n, f = kw.pop("n"), kw.pop("f")
    model, port, rng = fitted_forest(n=n, f=f, **kw)
    thr, feat, child, value = port.device_nodes()
    pf = port.packed()
    assert pf.records.shape[1] % 4 == 0 and pf.route == "smem"
    xq = rng.uniform(-1.5, 1.5, size=(batch, f))
    x = torch.from_numpy(port._normalize(xq).astype(np.float32))
    leaves = walk_records(pf, x)
    assert torch.equal(leaves, ref.forest_leaves_ref(thr, feat, child, x,
                                                     pf.depth))
    assert torch.equal(pf.value.gather(1, leaves), value.gather(1, leaves))
    np.testing.assert_allclose(cluster_mean(pf, x).numpy(),
                               model.predict(xq, backend="numpy"),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("t", [1, 3, 8, 10, 17, 24, 30])
def test_tree_split_and_leader_sum_give_plain_bits(t):
    """The cluster's tree slices cover every tree once, none holds more
    than ceil(T / C) (the kernel sizes shared memory by it), and the
    leader's ascending sum gives ref.forest_predict_ref's bits."""
    flat = complete_forest(t, [4, 2, 5], f=6, seed=t)
    pf = port_forest(flat, 6).packed()
    assert pf.cluster == min(ops.FOREST_MAX_CLUSTER, t)
    slices = [ops.tree_slice(t, pf.cluster, r) for r in range(pf.cluster)]
    assert slices[0][0] == 0 and slices[-1][1] == t
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert max(t1 - t0 for t0, t1 in slices) == -(-t // pf.cluster)
    x = torch.from_numpy(np.random.default_rng(t).normal(
        size=(70, 6)).astype(np.float32))
    want = ref.forest_predict_ref(*pf.plain, x, pf.depth)
    assert torch.equal(cluster_mean(pf, x).view(torch.int32),
                       want.view(torch.int32))
    assert torch.equal(ops.forest_predict_packed(pf, x), want)


def test_large_forest_takes_the_l2_route():
    """The route is chosen by the slice's size alone: 24 complete trees of
    depth 11 (3 per CTA, 4096 records each) overflow the shared-memory
    slice; depth 9 fits."""
    big = port_forest(complete_forest(24, [11], f=5), 5).packed()
    small = port_forest(complete_forest(24, [9], f=5), 5).packed()
    assert big.route == "l2" and small.route == "smem"
    assert 3 * big.records.shape[1] * 20 > ops.FOREST_SMEM_SLICE_MAX
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(9, 5)).astype(np.float32))
    assert torch.equal(cluster_mean(big, x),
                       ref.forest_predict_ref(*big.plain, x, big.depth))


def test_pack_forest_checks_once():
    flat = complete_forest(3, [2], f=4)
    thr, feat, child, value = port_forest(flat, 4).device_nodes()
    with pytest.raises(ValueError, match="children"):
        ops.pack_forest(thr, feat, child + 100, value, 2)
    with pytest.raises(TypeError):
        ops.pack_forest(thr.double(), feat, child, value, 2)
    pf = ops.pack_forest(thr, feat, child, value, 2)
    assert pf.n_features == int(feat.max()) + 1
    with pytest.raises(ValueError, match="features"):
        ops._forest_args(pf, torch.zeros((2, pf.n_features - 1)))


def _ties(kind: str, rng):
    """(values, n_real) with the tie or padding case ``kind``."""
    b = 200
    v = rng.normal(size=b).astype(np.float32)
    top = np.float32(v.max() + 1)
    cases = {
        "tie_in_lane": ((3, 35), b),          # one lane scans both rows
        "tie_across_lanes": ((36, 5), b),
        "tie_at_block_edge": ((64, 63), b),
        "tie_across_clusters": ((130, 10), b),
        "tie_in_last_cluster": ((199, 150), b),
        "n_real_1": ((150,), 1),
        "padding_tail": ((150,), 140),
        "one_row_in_last_cluster": ((120, 128), 129),
    }
    if kind == "all_equal":
        return np.zeros(b, np.float32).tolist(), 96
    if kind == "signed_zero":
        v = np.full(b, -1.0, np.float32)
        v[9], v[5] = 0.0, -0.0
        return v.tolist(), b
    rows, n_real = cases[kind]
    for r in rows:
        v[r] = top
    return v.tolist(), n_real


@pytest.mark.parametrize("kind", [
    "tie_in_lane", "tie_across_lanes", "tie_at_block_edge",
    "tie_across_clusters", "tie_in_last_cluster", "n_real_1",
    "padding_tail", "one_row_in_last_cluster", "all_equal", "signed_zero"])
def test_kernel_argmax_keeps_first_max(kind):
    vals, n_real = _ties(kind, np.random.default_rng(len(kind)))
    masked = torch.tensor(vals)
    masked[n_real:] = float("-inf")
    j = int(torch.argmax(masked))
    best, arg = kernel_argmax(vals, n_real)
    assert arg == j
    assert np.float32(best).tobytes() == masked[j].numpy().tobytes()


def test_score_block_max_packed_writes_value_bits_and_row():
    _, port, rng = fitted_forest(n_trees=6, max_depth=5, n=120, f=4)
    pf = port.packed()
    x = torch.from_numpy(rng.uniform(-1, 1, size=(70, 4)).astype(np.float32))
    xm = torch.from_numpy(port._xm.astype(np.float32))
    xs = torch.from_numpy(port._xs.astype(np.float32))
    out = torch.empty(2, dtype=torch.int32)
    for n_real in (1, 64, 65, 70):
        ops.score_block_max_packed(pf, xm, xs, x, n_real, out)
        v, j = ref.score_block_max_ref(*pf.plain, xm, xs, x, n_real,
                                       pf.depth)
        assert int(out[1]) == int(j)
        assert int(out[0]) == int(v.view(torch.int32))
        vals = ref.forest_predict_ref(*pf.plain, (x - xm) / xs, pf.depth)
        assert kernel_argmax(vals.tolist(), n_real)[1] == int(j)
    with pytest.raises(ValueError, match="n_real"):
        ops.score_block_max_packed(pf, xm, xs, x, 71, out)


@pytest.mark.parametrize("spec_fn,swaps,links", [
    (spec_tiny, 8, 8), (spec_16, 24, 24), (spec_64, 60, 60)])
def test_meta_scorer_cpu_matches_plain_tail(spec_fn, swaps, links):
    """MetaScorer's 8-byte read-back gives the (j, value) of the plain tail
    on the same fused features, as the scorer returned before."""
    spec = spec_fn()
    rng = np.random.default_rng(5)
    designs = [random_design(spec, rng) for _ in range(60)]
    x = design_features_batch(spec, designs)
    y = rng.normal(size=60) + x[:, 0]
    model = RegressionForest(seed=0, device="cpu").fit(x, y)
    sc = MetaScorer(spec, model, device="cpu")
    for i, d in enumerate(designs[:3]):
        mv = sample_neighbor_moves(spec, d, np.random.default_rng(i), swaps,
                                   links)
        base_perm, base_lm, scalars = sc._base_state(d)
        feats = fused_features(
            sc.c, sc._h["k"], torch.as_tensor(base_perm),
            torch.as_tensor(base_lm),
            tuple(torch.as_tensor(s) for s in scalars),
            *(torch.as_tensor(a) for a in sc._encode(mv)))
        v, j = ref.score_block_max_ref(*model.device_nodes("cpu"), sc.xm,
                                       sc.xs, feats, len(mv),
                                       model._flat["depth"])
        assert sc.score_moves(mv) == (int(j), float(v))
