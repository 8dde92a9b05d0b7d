"""The port's forest (kernel K2's plain version) and fused meta scorer
(kernel K3's plain version) against the JAX reference, on the CPU.

The forest comes from the reference through ``repro_torch.convert``, so
both packages hold the same trees. The port traverses in f32 like the
reference's jnp twin and Pallas kernel: identical leaves, and within 1e-6
of the f64 numpy oracle (f32 threshold rounding) on the shapes of
tests/test_forest_conformance.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.features import design_features_batch
from repro.core.forest import RegressionForest as RefForest
from repro.core.forest import flat_forest_eval
from repro.core.fused import MetaScorer as RefScorer
from repro.core.problem import random_design as ref_random_design
from repro.core.problem import sample_neighbor_moves as ref_sample_moves
from repro.core.problem import spec_16, spec_64, spec_tiny
from repro_torch.convert import forest_from_flat
from repro_torch.core.forest import RegressionForest, check_forest_backend
from repro_torch.core.fused import MetaScorer, check_meta_backend
from repro_torch.core.problem import sample_neighbor_moves
from repro_torch.kernels import ref


def _fit(n=200, f=5, seed=0, **kw):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, f))
    y = x[:, 0] * 2 + np.sin(3 * x[:, 1]) + 0.1 * rng.normal(size=n)
    return RefForest(seed=seed, **kw).fit(x, y), rng


def _port(model):
    return forest_from_flat(model._flat, model._xm, model._xs, device="cpu")


def _jnp_leaves(model, xn):
    """(T, B) leaf indices of the reference jnp twin: its traversal run one
    tree at a time with node ids as leaf values."""
    (thrfeat, child, _), (depth, n_trees, m) = model.jnp_tensors()
    out = []
    for t in range(n_trees):
        ids = jnp.arange(m, dtype=jnp.float32)
        leaf = flat_forest_eval(thrfeat[t * m:(t + 1) * m],
                                child[2 * t * m:2 * (t + 1) * m] - t * m,
                                ids, jnp.asarray(xn, jnp.float32), depth, 1, m)
        out.append(np.asarray(leaf).astype(np.int64))
    return np.stack(out)


def _check(model, xq):
    port = _port(model)
    got = port.predict(xq)
    np.testing.assert_allclose(got, model.predict(xq, backend="numpy"),
                               rtol=0, atol=1e-6)
    xn = port._normalize(xq).astype(np.float32)
    thr, feat, child, _ = port.device_nodes()
    leaves = ref.forest_leaves_ref(thr, feat, child, torch.from_numpy(xn),
                                   port._flat["depth"])
    assert np.array_equal(leaves.numpy(), _jnp_leaves(model, xn))
    np.testing.assert_allclose(got, model.predict(xq, backend="jnp"),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("batch", [1, 5, 127, 128, 129, 500, 1025])
def test_forest_conformance_over_batch_shapes(batch):
    model, rng = _fit(n=300, f=6, n_trees=10, max_depth=7)
    _check(model, rng.uniform(-1.5, 1.5, size=(batch, 6)))


@pytest.mark.parametrize("kw,n,f,batch", [
    (dict(n_trees=5, max_depth=0), 100, 3, 17),                 # one leaf
    (dict(n_trees=6, max_depth=16, min_leaf=1), 256, 4, 77),    # deepest
    (dict(n_trees=12, max_depth=6, min_leaf=1), 60, 5, 33),     # ragged
])
def test_forest_conformance_tree_shapes(kw, n, f, batch):
    model, rng = _fit(n=n, f=f, **kw)
    _check(model, rng.uniform(-1, 1, size=(batch, f)))


def test_port_fit_grows_the_reference_trees():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(150, 6))
    y = x[:, 1] - x[:, 2] ** 2
    a = RefForest(seed=4, n_trees=6).fit(x, y)
    b = RegressionForest(seed=4, n_trees=6, device="cpu").fit(x, y)
    for k in ("feature", "threshold", "left", "right", "value"):
        assert np.array_equal(a._flat[k], b._flat[k])
    xq = rng.uniform(-1, 1, size=(20, 6))
    assert np.array_equal(a.predict(xq, backend="numpy"),
                          b.predict(xq, backend="numpy"))


def _stage_forest(spec, seed=0, n=80):
    rng = np.random.default_rng(seed)
    designs = [ref_random_design(spec, rng) for _ in range(n)]
    x = design_features_batch(spec, designs)
    y = rng.normal(size=n) + x[:, 0] + x[:, 13]
    return RefForest(seed=seed).fit(x, y), designs


@pytest.mark.parametrize("spec_fn", [spec_tiny, spec_16, spec_64])
def test_score_moves_matches_reference_and_pallas(spec_fn):
    spec = spec_fn()
    model, designs = _stage_forest(spec)
    port = MetaScorer(spec, _port(model), device="cpu")
    jnp_sc = RefScorer(spec, model, backend="fused")
    pallas_sc = RefScorer(spec, model, backend="fused-pallas", interpret=True)
    for i, d in enumerate(designs[:4]):
        mv = sample_neighbor_moves(spec, d, np.random.default_rng(i), 24, 24)
        rmv = ref_sample_moves(spec, d, np.random.default_rng(i), 24, 24)
        j, v = port.score_moves(mv)
        for sc in (jnp_sc, pallas_sc):
            rj, rv = sc.score_moves(rmv)
            assert j == rj
            assert abs(v - rv) <= 1e-6
        assert abs(port.score_base(d) - jnp_sc.score_base(d)) <= 1e-6


def test_score_block_max_plain_first_max_and_padding():
    model, _ = _fit(n=120, f=4, n_trees=6, max_depth=5)
    port = _port(model)
    nodes = port.device_nodes()
    depth = port._flat["depth"]
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.uniform(-1, 1, size=(50, 4)).astype(np.float32))
    xm = torch.from_numpy(port._xm.astype(np.float32))
    xs = torch.from_numpy(port._xs.astype(np.float32))
    vals = ref.forest_predict_ref(*nodes, (x - xm) / xs, depth)
    j0 = int(torch.argmax(vals))
    x[45] = x[j0]
    x[2] = x[j0]
    v, j = ref.score_block_max_ref(*nodes, xm, xs, x, 50, depth)
    assert int(j) == min(2, j0) and float(v) == float(vals[j0])
    # the tied duplicate at row 45 is padding once n_real <= 45
    keep = 45 if j0 >= 45 else j0 + 1
    v2, j2 = ref.score_block_max_ref(*nodes, xm, xs, x, keep, depth)
    assert int(j2) < keep


def test_backend_knobs_name_the_port_values():
    for old in ("jnp", "pallas"):
        with pytest.raises(ValueError, match="'auto'"):
            check_forest_backend(old)
    with pytest.raises(ValueError, match="'fused'"):
        check_meta_backend("fused-pallas")
    check_forest_backend("numpy")
    check_meta_backend("host")
    with pytest.raises(ValueError):
        MetaScorer(spec_tiny(), _port(_fit()[0]), backend="host",
                   device="cpu")
