"""The port's MoE FFN (``repro_torch.models.moe``) on the CPU against the
JAX package's (``repro.models.moe``), in f32 compute, on the same weights
and tokens drawn with numpy.

``moe_ffn``: y within 1e-5 and the aux loss within 1e-6; the expert ids
and the kept buffer slots identical to the reference's routing. Cases: one
short group, two whole groups, a ragged tail (passed through unchanged),
an overloaded expert (tokens dropped at the capacity) and two equal router
columns (the lower expert wins the tie). The capacity formula at half-way
cases (Python's round, half to even). Then the full configs' parameter
trees on the meta device against ``jax.eval_shape`` of the reference's
init (whisper-base's too), the in-place layer stacking, the bf16 model's aliased cast, and the
launchers on the MoE smoke config. The MoE models' forward, prefill,
decode, ``Engine`` tokens and loss gradients against the reference are
cases of ``tests/test_torch_llm_serve.py`` and
``tests/test_torch_train_grads.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build as ref_build
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.models import build, build_train, moe
from repro_torch.models.common import MetaGenerator, stack_layers
from repro_torch.models.model import _CAST, _leaves

ARCH = "qwen3-moe-30b-a3b"
Y_TOL = 1e-5
AUX_TOL = 1e-6


def _cfgs(arch=ARCH):
    rcfg = ref_get_config(arch, smoke=True).scaled(compute_dtype=jnp.float32)
    cfg = get_config(arch, smoke=True).scaled(compute_dtype=torch.float32)
    return rcfg, cfg


def _layer(cfg, seed=0, bias=None, tie=None):
    """One MoE layer's weights as numpy: a router of scale 1/sqrt(D) and
    experts; ``bias`` {expert: weight} on feature 0 of the router,
    ``tie`` (a, b) makes router column b equal to column a."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w1": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w3": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w2": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    for expert, w in (bias or {}).items():
        p["router"][0, expert] = w
    if tie is not None:
        p["router"][:, tie[1]] = p["router"][:, tie[0]]
    return p


def _tokens(cfg, b, s, seed=1, feature0=None):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    if feature0 is not None:
        x[..., 0] = feature0
    return x


def _ref_routing(rcfg, router, x):
    """The reference's routing of ``x``, its own lines (moe.py:39-61):
    (expert ids, buffer slots, kept)."""
    e, k = rcfg.n_experts, rcfg.top_k
    tokens = x.reshape(-1, x.shape[-1])
    g_size = min(ref_moe.GROUP_SIZE, tokens.shape[0])
    n = tokens.shape[0] // g_size
    xg = jnp.asarray(tokens[:n * g_size].reshape(n, g_size, -1))
    probs = jax.nn.softmax(xg @ jnp.asarray(router), axis=-1)
    _, ids = jax.lax.top_k(probs, k)
    sel = jax.nn.one_hot(ids, e, dtype=jnp.float32)
    pos = jnp.cumsum(sel.reshape(n, g_size * k, e), axis=1) - 1.0
    slots = jnp.sum(pos.reshape(n, g_size, k, e) * sel, axis=-1)
    cap = int(max(k, round(g_size * k / e * rcfg.capacity_factor)))
    return (np.asarray(ids), np.asarray(slots).astype(np.int64),
            np.asarray(slots < cap), probs)


def _hold(rcfg, cfg, p, x):
    """moe_ffn of both packages on ``x``: y, aux, routing identical."""
    ry, raux = ref_moe.moe_ffn(rcfg, {k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    y, aux = moe.moe_ffn(cfg, tp, torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=Y_TOL,
                               atol=Y_TOL)
    assert abs(aux.item() - float(raux)) <= AUX_TOL
    ids, slots, kept, _ = _ref_routing(rcfg, p["router"], x)
    d = x.shape[-1]
    t = x.reshape(-1, d).shape[0]
    g_size = min(moe.GROUP_SIZE, t)
    xg = torch.from_numpy(x.reshape(-1, d)[:t // g_size * g_size]).reshape(
        t // g_size, g_size, d)
    r = moe.route(cfg, tp["router"], xg)
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    np.testing.assert_array_equal(r.slots.numpy()[kept], slots[kept])
    return y, r


@pytest.mark.parametrize("b,s", [(2, 8), (2, 1024), (1, 1100)],
                         ids=["t16_one_short_group", "t2048_two_groups",
                              "t1100_ragged_tail"])
def test_moe_ffn_matches_reference(b, s):
    rcfg, cfg = _cfgs()
    x = _tokens(cfg, b, s)
    y, r = _hold(rcfg, cfg, _layer(cfg), x)
    t = b * s
    assert r.expert_ids.shape[:2] == (t // min(1024, t), min(1024, t))
    if t > 1024 and t % 1024:
        # Tokens past the last whole group come back as they came in.
        assert torch.equal(y.reshape(t, -1)[1024:],
                           torch.from_numpy(x.reshape(t, -1)[1024:]))


@pytest.mark.parametrize("t", [24, 40, 64])
def test_overloaded_expert_drops_tokens_as_the_reference(t):
    rcfg, cfg = _cfgs()
    x = _tokens(cfg, 1, t, feature0=3.0)
    _, r = _hold(rcfg, cfg, _layer(cfg, bias={3: 5.0}), x)
    assert (r.expert_ids[..., 0] == 3).all()
    dropped = int((~r.kept).sum())
    assert dropped >= t - r.capacity > 0


def test_equal_router_columns_keep_the_lower_expert():
    rcfg, cfg = _cfgs()
    x = _tokens(cfg, 2, 16, feature0=3.0)
    p = _layer(cfg, bias={0: 5.0, 2: 2.5}, tie=(2, 5))
    ids_ref, _, _, probs = _ref_routing(rcfg, p["router"], x)
    probs = np.asarray(probs)
    assert np.array_equal(probs[..., 2], probs[..., 5])   # an exact tie
    _, r = _hold(rcfg, cfg, p, x)
    assert cfg.top_k == 2
    assert (r.expert_ids[..., 0] == 0).all() and (r.expert_ids[..., 1] == 2
                                                  ).all()
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids_ref)


@pytest.mark.parametrize("g_size,want", [(8, 2), (24, 8), (40, 12),
                                         (56, 18), (1024, 320)])
def test_capacity_rounds_half_to_even(g_size, want):
    _, cfg = _cfgs()                 # e = 8, k = 2, capacity_factor 1.25
    assert g_size * cfg.top_k / cfg.n_experts * cfg.capacity_factor % 1 in (
        0.5, 0.0)
    assert moe.capacity(cfg, g_size) == want


def test_moe_ffn_gradients_match_reference():
    rcfg, cfg = _cfgs()
    x = _tokens(cfg, 2, 12)
    p = _layer(cfg)

    def ref_loss(p, x):
        y, aux = ref_moe.moe_ffn(rcfg, p, x)
        return jnp.sum(y * y) + aux

    rl, (rg, rgx) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_ffn(cfg, tp, tx)
    loss = (y * y).sum() + aux
    grads = torch.autograd.grad(loss, [*tp.values(), tx])
    assert loss.item() == pytest.approx(float(rl), rel=Y_TOL)
    for g, r in zip(grads, [*(rg[k] for k in tp), rgx]):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        assert float(np.abs(g.numpy() - r).max()) <= Y_TOL * scale


# ------------------------------------------------------------- params
def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("arch,dtype", [
    ("qwen3-moe-30b-a3b", "float32"), ("qwen3-moe-30b-a3b", "bfloat16"),
    ("moonshot-v1-16b-a3b", "float32"), ("whisper-base", "float32"),
    ("whisper-base", "bfloat16")])
def test_full_config_tree_on_meta_equals_the_references(arch, dtype):
    rcfg = ref_get_config(arch).scaled(dtype=getattr(jnp, dtype))
    cfg = get_config(arch).scaled(dtype=getattr(torch, dtype))
    want = jax.eval_shape(ref_build(rcfg).init, jax.random.PRNGKey(0))
    got = build_train(cfg, device="cpu").init(0, device="meta")
    assert _shapes(got) == _shapes(want)
    if cfg.family == "moe":
        assert _shapes(got)["layers.moe.router"][1] == "float32"


def test_stack_layers_fills_one_allocation_per_leaf():
    gen = torch.Generator().manual_seed(0)
    draws = []

    def draw():
        draws.append({"a": torch.randn(3, generator=gen),
                      "b": {"c": torch.randn(2, 2, generator=gen)}})
        return draws[-1]

    out = stack_layers(4, draw)
    assert len(draws) == 4
    assert torch.equal(out["a"], torch.stack([d["a"] for d in draws]))
    assert torch.equal(out["b"]["c"], torch.stack([d["b"]["c"]
                                                   for d in draws]))
    with torch.no_grad():
        meta = stack_layers(2, lambda: moe.init_moe_layer(
            get_config(ARCH), MetaGenerator()))
    assert meta["w1"].shape == (2, 128, 2048, 768)
    assert meta["w1"].device.type == "meta"


def test_bf16_model_casts_nothing_and_keeps_the_router_f32():
    cfg = get_config(ARCH, smoke=True).scaled(dtype=torch.bfloat16)
    assert cfg.compute_dtype == torch.bfloat16
    model = build(cfg, seed=0, device="cpu")
    for path, key, v in _leaves(model.params):
        run = model.run_params
        for part in path.split("."):
            run = run[part]
        assert run is v, path
        if key == "router":
            assert v.dtype == torch.float32
        elif key in _CAST:
            assert v.dtype == torch.bfloat16


# ------------------------------------------------------------ launchers
def test_serve_launcher_serves_moe(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "moonshot-v1-16b-a3b", "--smoke", "--device",
                 "cpu", "--batch", "2", "--prompt-len", "8", "--new",
                 "3"]) == 0
    out = capsys.readouterr().out
    assert "moonshot-v1-16b-a3b on cpu" in out and "sample:" in out


def test_train_launcher_trains_moe(tmp_path, capsys):
    from repro_torch.launch.train import main
    assert main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                 "4", "--seq-len", "32", "--global-batch", "2",
                 "--ckpt-dir", str(tmp_path)]) == 0
    assert f"[train] {ARCH} on cpu: step 4 loss" in capsys.readouterr().out
