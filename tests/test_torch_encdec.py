"""The port's encoder-decoder (``repro_torch.models.encdec``) on the CPU
against the JAX package's (``repro.models.encdec``): whisper-base's smoke
config in f32 compute, the reference's weights carried over by
``convert.params_from_jax``, frames and tokens drawn with numpy.

``encode``, ``decode_full``, the loss and every gradient leaf, ``prefill``
(logits and the k/v/ek/ev caches) and four decode steps; then a greedy
generation through ``EncDecModel``, remat, and ``params_from_jax``'s
layout checks (the full config's parameter tree is a case of
``tests/test_torch_moe.py``). Tolerance 1e-4 (as
tests/test_torch_llm_serve.py); the loss 1e-5 relative and each gradient
leaf 1e-5 of its largest magnitude (as tests/test_torch_train_grads.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build as ref_build
from repro.models import encdec as ref_encdec
from repro_torch.ckpt.checkpoint import tree_leaves
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import EncDecModel, build, build_train, encdec
from repro_torch.train.train_step import batch_to

ARCH = "whisper-base"
TOL = 1e-4
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-5
BATCH, ENC_LEN, SEQ, MAX_LEN = 2, 30, 8, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(remat=False):
    rcfg = ref_get_config(ARCH, smoke=True).scaled(
        remat=False, compute_dtype=jnp.float32)
    cfg = get_config(ARCH, smoke=True).scaled(
        remat=remat, compute_dtype=torch.float32)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((BATCH, ENC_LEN, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab, size=(BATCH, SEQ)).astype(np.int32)
    return rcfg, rmodel, rparams, cfg, frames, tokens


def _port_params(cfg, rparams):
    return params_from_jax(cfg, jax.tree.map(np.asarray, rparams))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               rtol=tol, atol=tol)


def test_encode_and_decode_full_match_reference():
    rcfg, _, rparams, cfg, frames, tokens = _pair()
    params = _port_params(cfg, rparams)
    renc = ref_encdec.encode(rcfg, rparams, jnp.asarray(frames))
    enc = encdec.encode(cfg, params, torch.from_numpy(frames))
    assert enc.shape == (BATCH, ENC_LEN, cfg.d_model)
    _close(enc, renc)
    want = ref_encdec.decode_full(rcfg, rparams, jnp.asarray(tokens), renc)
    got = encdec.decode_full(cfg, params, torch.from_numpy(tokens).long(),
                             enc)
    assert got.shape == (BATCH, SEQ, cfg.vocab)
    _close(got, want)


def _batch(cfg, frames, tokens):
    targets = np.roll(tokens, -1, axis=1)
    return {"frames": frames, "tokens": tokens, "targets": targets}


def _port_grads(cfg, rparams, batch):
    params = _port_params(cfg, rparams)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss = build_train(cfg, device="cpu").loss(params, batch_to(batch, "cpu"))
    return loss, torch.autograd.grad(loss, tree_leaves(params))


def test_loss_and_gradients_match_the_reference():
    rcfg, rmodel, rparams, cfg, frames, tokens = _pair()
    batch = _batch(cfg, frames, tokens)
    rloss, rgrads = jax.jit(jax.value_and_grad(rmodel.loss))(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_grads(cfg, rparams, batch)
    assert loss.item() == pytest.approx(float(rloss), rel=LOSS_RTOL)
    rleaves = jax.tree.leaves(rgrads)
    assert len(grads) == len(rleaves)
    for g, r in zip(grads, rleaves):
        r = np.asarray(r)
        assert g.shape == r.shape
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(g.numpy() - r).max()) <= LEAF_TOL * scale


def test_remat_gives_the_same_gradients(monkeypatch):
    from repro_torch.models import transformer
    rcfg, _, rparams, cfg, frames, tokens = _pair()
    batch = _batch(cfg, frames, tokens)
    loss, grads = _port_grads(cfg, rparams, batch)
    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rloss, rgrads = _port_grads(cfg.scaled(remat=True), rparams, batch)
    assert len(calls) == cfg.encoder_layers + cfg.n_layers
    assert torch.equal(loss, rloss)
    for a, b in zip(grads, rgrads):
        assert torch.equal(a, b)


def test_prefill_and_decode_match_reference():
    rcfg, rmodel, rparams, cfg, frames, tokens = _pair()
    model = build(cfg, _port_params(cfg, rparams), device="cpu")
    assert isinstance(model, EncDecModel)
    rlogits, rcache = rmodel.prefill(rparams, jnp.asarray(frames),
                                     jnp.asarray(tokens), MAX_LEN)
    logits, cache = model.prefill(torch.from_numpy(frames),
                                  torch.from_numpy(tokens).long(), MAX_LEN)
    _close(logits, rlogits)
    assert cache["pos"] == int(rcache["pos"]) == SEQ
    assert set(cache) == set(rcache) == {"k", "v", "ek", "ev", "pos"}
    for key in ("k", "v", "ek", "ev"):
        assert tuple(cache[key].shape) == rcache[key].shape, key
        assert str(cache[key].dtype).split(".")[-1] == str(
            rcache[key].dtype), key
        _close(cache[key], rcache[key])

    steps = np.random.default_rng(2).integers(0, cfg.vocab,
                                              size=(4, BATCH, 1))
    for tok in steps.astype(np.int32):
        rlogits, rcache = rmodel.decode_step(rparams, rcache,
                                             jnp.asarray(tok))
        logits, cache = model.decode_step(cache, torch.from_numpy(tok).long())
        _close(logits, rlogits)
    assert cache["pos"] == int(rcache["pos"]) == SEQ + 4
    for key in ("k", "v"):
        _close(cache[key], rcache[key])


def test_greedy_generation_matches_reference():
    rcfg, rmodel, rparams, cfg, frames, tokens = _pair()
    model = build(cfg, _port_params(cfg, rparams), device="cpu")
    rlogits, rcache = rmodel.prefill(rparams, jnp.asarray(frames),
                                     jnp.asarray(tokens), MAX_LEN)
    logits, cache = model.prefill(torch.from_numpy(frames),
                                  torch.from_numpy(tokens).long(), MAX_LEN)
    for _ in range(6):
        rtok = jnp.argmax(rlogits[:, -1], -1).astype(jnp.int32)[:, None]
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
        rlogits, rcache = rmodel.decode_step(rparams, rcache, rtok)
        logits, cache = model.decode_step(cache, tok)


def test_init_cache_matches_reference_layout():
    rcfg, rmodel, _, cfg, _, _ = _pair()
    model = build(cfg, seed=0, device="cpu")
    cache = model.init_cache(BATCH, MAX_LEN, ENC_LEN, torch.float32)
    rcache = rmodel.init_cache(BATCH, MAX_LEN, ENC_LEN, jnp.float32)
    assert cache["pos"] == 0
    for key in ("k", "v", "ek", "ev"):
        assert tuple(cache[key].shape) == rcache[key].shape, key


def test_params_from_jax_checks_the_encdec_layout():
    _, _, rparams, cfg, _, _ = _pair()
    tree = jax.tree.map(np.asarray, rparams)
    bad = dict(tree, encoder=jax.tree.map(lambda a: a[:1], tree["encoder"]))
    with pytest.raises(ValueError, match="encoder.*expected 2 stacked"):
        params_from_jax(cfg, bad)
    bad = dict(tree, decoder=jax.tree.map(lambda a: a[:1], tree["decoder"]))
    with pytest.raises(ValueError, match="decoder.*expected 2 stacked"):
        params_from_jax(cfg, bad)
    with pytest.raises(ValueError, match="top-level keys"):
        params_from_jax(cfg, {k: v for k, v in tree.items()
                              if k != "enc_norm"})


def test_train_launcher_refuses_encdec(tmp_path):
    from repro_torch.launch.train import main
    with pytest.raises(NotImplementedError, match="audio frames"):
        main(["--arch", ARCH, "--smoke", "--device", "cpu",
              "--ckpt-dir", str(tmp_path)])
