"""The port's serving path on the CPU against the JAX package: the smoke
configs of the decoder-only families (dense, VLM, MoE, SSM, hybrid) in f32
compute, with the reference's weights carried over by
``convert.params_from_jax``.

For each: ``forward_full`` hidden states, ``prefill`` logits and caches,
four ``decode_step``s, and ``Engine.generate`` tokens against the reference
``Engine``. Tolerance 5e-3 (tests/test_archs.py) for the hybrid, whose KV
cache is bf16 as in the reference; 1e-4 for the others, which holds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.dist import sharding as shd
from repro.launch.mesh import make_host_mesh
from repro.models import build as ref_build
from repro.models import transformer as ref_tf
from repro.serve import Engine as RefEngine
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import params_from_jax
from repro_torch.dist.sharding import Policy
from repro_torch.launch.mesh import make_host_mesh as host_mesh
from repro_torch.models import build
from repro_torch.serve import Engine, ServeConfig

ARCHS = ["zamba2-2.7b", "mamba2-1.3b", "yi-6b", "gemma3-1b",
         "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "chameleon-34b",
         "deepseek-coder-33b", "mistral-large-123b"]
TOL = {"zamba2-2.7b": 5e-3, "mamba2-1.3b": 1e-4, "yi-6b": 1e-4,
       "gemma3-1b": 1e-4, "qwen3-moe-30b-a3b": 1e-4,
       "moonshot-v1-16b-a3b": 1e-4, "chameleon-34b": 1e-4,
       "deepseek-coder-33b": 1e-4, "mistral-large-123b": 1e-4}
BATCH, SEQ, MAX_LEN = 2, 24, 32


def _pair(arch):
    rcfg = ref_get_config(arch, smoke=True).scaled(
        remat=False, compute_dtype=jnp.float32)
    cfg = get_config(arch, smoke=True).scaled(compute_dtype=torch.float32)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, rparams)
    model = build(cfg, params_from_jax(cfg, tree), device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(BATCH, SEQ)).astype(np.int32)
    return rcfg, rmodel, rparams, model, tokens


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_port_configs_equal_the_references():
    from repro.configs import ARCH_NAMES as REF_NAMES
    assert ARCH_NAMES == REF_NAMES
    for name in ARCH_NAMES:
        for smoke in (False, True):
            cfg, rcfg = get_config(name, smoke), ref_get_config(name, smoke)
            mine = {k: v for k, v in vars(cfg).items()
                    if k not in ("dtype", "compute_dtype")}
            theirs = {k: v for k, v in vars(rcfg).items() if k in mine}
            assert mine == theirs, name
            assert set(vars(rcfg)) - set(vars(cfg)) == {"unroll_layers"}
            assert cfg.remat == rcfg.remat
            assert cfg.param_count() == rcfg.param_count()
            assert cfg.resolved_head_dim == rcfg.resolved_head_dim
            assert str(cfg.compute_dtype).endswith("bfloat16")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_full_matches_reference(arch):
    rcfg, _, rparams, model, tokens = _pair(arch)
    want, _, _ = ref_tf.forward_full(rcfg, rparams, jnp.asarray(tokens))
    got = model.forward_full(torch.from_numpy(tokens))
    _close(got, want, TOL[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    rcfg, rmodel, rparams, model, tokens = _pair(arch)
    rlogits, rcache = rmodel.prefill(rparams, jnp.asarray(tokens), MAX_LEN)
    logits, cache = model.prefill(torch.from_numpy(tokens), MAX_LEN)
    tol = TOL[arch]
    _close(logits, rlogits, tol)
    assert cache["pos"] == int(rcache["pos"]) == SEQ
    assert set(cache) == set(rcache)
    for key in set(cache) - {"pos"}:
        assert tuple(cache[key].shape) == rcache[key].shape, key
        assert str(cache[key].dtype).split(".")[-1] == str(
            rcache[key].dtype), key
        _close(cache[key], rcache[key], tol)

    steps = np.random.default_rng(2).integers(0, rcfg.vocab,
                                              size=(4, BATCH, 1))
    for tok in steps.astype(np.int32):
        rlogits, rcache = rmodel.decode_step(rparams, rcache, jnp.asarray(tok))
        logits, cache = model.decode_step(cache, torch.from_numpy(tok))
        _close(logits, rlogits, tol)
    assert cache["pos"] == int(rcache["pos"]) == SEQ + 4
    for key in set(cache) - {"pos"}:
        _close(cache[key], rcache[key], tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generates_the_references_tokens(arch):
    rcfg, rmodel, rparams, model, tokens = _pair(arch)
    scfg = dict(max_new_tokens=6, max_len=MAX_LEN)
    reng = RefEngine(rmodel, make_host_mesh(), shd.Policy(), rparams,
                     RefServeConfig(**scfg))
    eng = Engine(model, host_mesh(), Policy(), None, ServeConfig(**scfg))
    got = eng.generate(tokens)
    assert got.dtype == np.int32 and got.shape == (BATCH, 6)
    np.testing.assert_array_equal(got, reng.generate(tokens))
    assert eng.stats["new_tokens"] == got.size
    assert eng.stats["decode_steps"] == 5


def test_greedy_takes_the_first_maximum():
    from repro_torch.serve.engine import _greedy
    logits = torch.tensor([[[0.0, 3.0, 3.0, 1.0]], [[2.0, 2.0, 2.0, 2.0]]])
    assert _greedy(logits).tolist() == [[1], [0]]
    assert jnp.argmax(jnp.asarray(logits.numpy())[:, -1], -1).tolist() == [1, 0]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_arch_builds_on_cpu(arch):
    from repro_torch.models import EncDecModel, build_train
    cfg = get_config(arch, smoke=True)
    model = build(cfg, seed=0, device="cpu")
    assert isinstance(model, EncDecModel) == (cfg.family == "encdec")
    params = build_train(cfg, device="cpu").init(0)
    assert {k for k in params} == {k for k in model.params}


def test_params_from_jax_checks_the_layout():
    cfg = get_config("yi-6b", smoke=True)
    with pytest.raises(ValueError, match="top-level keys"):
        params_from_jax(cfg, {"embed": np.zeros((2, 2))})


def test_launcher_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "8", "--new", "3"]) == 0
    out = capsys.readouterr().out
    assert "zamba2-2.7b on cpu" in out and "sample:" in out
    with pytest.raises(SystemExit):
        main(["--arch", "whisper-base", "--smoke", "--device", "cpu"])
