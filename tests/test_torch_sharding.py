"""The port's spec builders (``repro_torch.dist.sharding``) against the
reference's on the CPU, with no devices: ``param_specs``, ``batch_specs``
and ``cache_specs`` of every architecture at full width, leaf by leaf, on
abstract meshes (``jax.sharding.AbstractMesh`` beside the port's
``Mesh`` with the same axes), under five policies. The builders are shape
logic, so they must agree exactly.

No weight is regrouped: the port keeps every leaf in the reference's
layout and spec (mamba2's packed ``in_proj`` included; its compute
gathers that weight over ``model`` before use, see models/mamba2.py)."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.dist import sharding as ref_shd
from repro.models import build as ref_build
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import build_train, encdec, transformer

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
POLICIES = {
    "train": lambda m: m.default_policy_for("train"),
    "inference": lambda m: m.default_policy_for("inference"),
    "serve_no_tp": lambda m: m.Policy().with_logical(
        heads=(), kv_heads=(), heads_flat=(), vocab=(), mlp=()),
    "seq_model": lambda m: m.Policy().with_logical(seq=("model",)),
    "no_ep": lambda m: m.Policy().with_logical(experts=()),
}
BATCH, SEQ, MAX_LEN, ENC_LEN = 8, 512, 536, 1500


def _entry(e) -> tuple:
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def _norm(p) -> tuple:
    """A reference PartitionSpec as the port's spec tuple."""
    parts = [_entry(e) for e in p]
    while parts and not parts[-1]:
        parts.pop()
    return tuple(parts)


def _flat_ref(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(k.key for k in path): _norm(s) for path, s in leaves}


def _flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(reference abstract params, the port's meta params, reference and
    port caches) at full width."""
    rcfg = ref_get_config(arch)
    rmodel = ref_build(rcfg)
    rparams = rmodel.abstract_params()
    cfg = get_config(arch)
    params = build_train(cfg, device="cpu").init(0, device="meta")
    if cfg.family == "encdec":
        rcache = jax.eval_shape(lambda: rmodel.init_cache(BATCH, MAX_LEN,
                                                          ENC_LEN))
        cache = encdec.init_cache(cfg, BATCH, MAX_LEN, ENC_LEN,
                                  device="meta")
    else:
        rcache = jax.eval_shape(lambda: rmodel.init_cache(BATCH, MAX_LEN))
        cache = transformer.init_cache(cfg, BATCH, MAX_LEN, device="meta")
    cache["pos"] = torch.zeros((), device="meta")
    return rcfg, rparams, rcache, cfg, params, cache


def _batch(cfg, lib):
    shapes = {"tokens": (BATCH, SEQ), "targets": (BATCH, SEQ),
              "mask": (BATCH, SEQ)}
    if cfg.family == "encdec":
        shapes["frames"] = (BATCH, ENC_LEN, cfg.d_model)
    if lib == "jax":
        return {k: jax.ShapeDtypeStruct(s, jnp.float32)
                for k, s in shapes.items()}
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_match_the_reference(arch, mesh, policy):
    shape, names = MESHES[mesh]
    rmesh = jax.sharding.AbstractMesh(shape, names)
    pmesh = Mesh(names, shape)
    rpol, pol = POLICIES[policy](ref_shd), POLICIES[policy](shd)
    rcfg, rparams, rcache, cfg, params, cache = _trees(arch)

    want = _flat_ref(ref_shd.param_specs(rmesh, rpol, rparams))
    got = _flat(shd.param_specs(pmesh, pol, params))
    assert got.keys() == want.keys()
    for path in want:
        assert got[path] == want[path], (path, got[path], want[path])
    # Each rank's shard shape divides evenly.
    for path, spec in got.items():
        leaf = functools.reduce(lambda t, k: t[k], path, params)
        assert len(shd.local_shape(pmesh, spec, leaf.shape)) == leaf.dim()

    want = _flat_ref(ref_shd.batch_specs(rmesh, rpol, _batch(cfg, "jax")))
    assert _flat(shd.batch_specs(pmesh, pol, _batch(cfg, "torch"))) == want

    want = _flat_ref(ref_shd.cache_specs(rmesh, rpol, rcfg, rcache))
    assert _flat(shd.cache_specs(pmesh, pol, cfg, cache)) == want


def test_production_meshes_are_the_references_shapes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}


def test_local_slice_numbers_shards_as_jax():
    """A dim split over ("data", "model") on a (2, 2) mesh: rank (d, m)
    holds shard d * 2 + m, as ``jax.make_mesh`` numbers them."""
    t = torch.arange(8 * 3).reshape(8, 3)
    for d in range(2):
        for m in range(2):
            mesh = Mesh(("data", "model"), (2, 2), coords=(d, m))
            got = shd.local_slice(mesh, (("data", "model"),), t)
            assert torch.equal(got, t[(d * 2 + m) * 2:(d * 2 + m + 1) * 2])
            got = shd.local_slice(mesh, ((), ("model",)), t[:, :2])
            assert torch.equal(got, t[:, m:m + 1])


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-2.7b", "qwen3-moe-30b-a3b",
                                  "whisper-base"])
def test_rank_params_tile_the_references_tree(arch):
    """``convert.rank_params`` on every rank of a (2, 2) mesh: each leaf's
    shards, placed by the spec, tile the reference's whole leaf; ``build``
    takes a rank's shards as they are."""
    import numpy as np

    from repro_torch.convert import rank_params
    from repro_torch.models import build

    rcfg = ref_get_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray, ref_build(rcfg).init(jax.random.PRNGKey(0)))
    cfg = get_config(arch, smoke=True).scaled(compute_dtype=torch.float32)
    pol = shd.Policy()
    specs = _flat(shd.param_specs(Mesh(("data", "model"), (2, 2)), pol,
                                  build_train(cfg, device="cpu").init(
                                      0, device="meta")))
    whole = _flat(jax.tree.map(torch.from_numpy, tree))
    seen = {p: torch.full(t.shape, float("nan")) for p, t in whole.items()}
    for d in range(2):
        for m in range(2):
            mesh = Mesh(("data", "model"), (2, 2), coords=(d, m))
            local = rank_params(cfg, tree, mesh, pol)
            for path, t in _flat(local).items():
                shd.local_slice(mesh, specs[path], seen[path]).copy_(t)
            model = build(cfg, local, device="cpu", mesh=mesh, policy=pol)
            assert all(torch.equal(a, b) for a, b in zip(
                _flat(model.params).values(), _flat(local).values()))
    for path, t in whole.items():
        assert torch.equal(seen[path], t.float() if t.is_floating_point()
                           else t), path
