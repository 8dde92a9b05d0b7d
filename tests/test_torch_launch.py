"""The launchers' parameter dtype (``--dtype``) and their memory reckoning
on the CPU, against the JAX package.

``--dtype bfloat16`` on a smoke config (f32 compute): the serve launcher
builds bf16 parameter leaves and generates the reference's tokens on the
same weights; the train launcher's first step has the reference's loss on
the same weights within 1e-5 relative (``LOSS_RTOL`` of
tests/test_torch_train_grads.py: both compute in f32 from the same bf16
values). The reckoning (``launch.memory``) is held at the full-width sizes
``ModelConfig.param_count`` gives, against an 80 GB card."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.dist import sharding as shd
from repro.launch.mesh import make_host_mesh
from repro.models import build as ref_build
from repro.serve import Engine as RefEngine
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.ckpt.checkpoint import tree_leaves
from repro_torch.configs import get_config
from repro_torch.launch import memory
from repro_torch.models import build_train

ARCH = "deepseek-coder-33b"
LOSS_RTOL = 1e-5
CARD_FREE = 80e9
#: Serving at 8 x 512 prompts, 16 new tokens (the launcher's cache is
#: prompt + new + 8 long).
BATCH, MAX_LEN = 8, 512 + 16 + 8


def _ref_bf16_params(params):
    """The port's bf16 parameter tree as the reference's (bf16 values are
    exact in f32 both ways)."""
    return jax.tree.map(lambda t: jnp.asarray(t.detach().float().numpy(),
                                              jnp.bfloat16), params)


def _ref_cfg():
    return ref_get_config(ARCH, smoke=True).scaled(
        dtype=jnp.bfloat16, compute_dtype=jnp.float32, remat=False)


def test_serve_launcher_bf16_has_bf16_leaves_and_the_references_tokens(
        monkeypatch):
    from repro_torch.launch import serve as launch_serve

    seen = {}

    class Recording(launch_serve.Engine):
        def generate(self, prompts):
            seen.update(model=self.model, prompts=prompts)
            seen["out"] = super().generate(prompts)
            return seen["out"]

    monkeypatch.setattr(launch_serve, "Engine", Recording)
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--dtype",
                              "bfloat16", "--device", "cpu", "--batch", "2",
                              "--prompt-len", "8", "--new", "4"]) == 0
    model = seen["model"]
    assert {t.dtype for t in tree_leaves(model.params)} == {torch.bfloat16}
    assert model.cfg.compute_dtype == torch.float32
    reng = RefEngine(ref_build(_ref_cfg()), make_host_mesh(), shd.Policy(),
                     _ref_bf16_params(model.params),
                     RefServeConfig(max_new_tokens=4, max_len=8 + 4 + 8))
    np.testing.assert_array_equal(seen["out"], reng.generate(seen["prompts"]))


def test_train_launcher_bf16_step_has_the_references_loss(tmp_path, capsys):
    from repro_torch.launch.train import main
    assert main(["--arch", ARCH, "--smoke", "--dtype", "bfloat16",
                 "--device", "cpu", "--steps", "1", "--seq-len", "32",
                 "--global-batch", "2", "--ckpt-dir", str(tmp_path)]) == 0
    loss = float(re.search(r"step 1 loss ([0-9.]+)",
                           capsys.readouterr().out).group(1))
    # The launcher's Trainer draws its parameters with seed 0.
    cfg = get_config(ARCH, smoke=True).scaled(dtype=torch.bfloat16,
                                              compute_dtype=torch.float32)
    params = build_train(cfg, device="cpu").init(0)
    assert {t.dtype for t in tree_leaves(params)} == {torch.bfloat16}
    batch = RefSyntheticLM(RefDataConfig(vocab=cfg.vocab, seq_len=32,
                                         global_batch=2)).batch(0)
    rloss = ref_build(_ref_cfg()).loss(
        _ref_bf16_params(params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert loss == pytest.approx(float(rloss), rel=LOSS_RTOL)


@pytest.mark.parametrize("arch,gb_f32,gb_bf16", [
    ("deepseek-coder-33b", 133.38, 66.69),
    ("chameleon-34b", 137.18, 68.59),
    ("mistral-large-123b", 490.45, 245.22),
    ("qwen3-moe-30b-a3b", 122.13, 61.06),
])
def test_param_bytes_are_the_param_count_in_the_dtype(arch, gb_f32, gb_bf16):
    cfg = get_config(arch)
    assert round(memory.param_bytes(cfg) / 1e9, 2) == gb_f32
    assert round(memory.param_bytes(
        cfg.scaled(dtype=torch.bfloat16)) / 1e9, 2) == gb_bf16


@pytest.mark.parametrize("arch,dtype,fits", [
    ("deepseek-coder-33b", "bfloat16", True),
    ("deepseek-coder-33b", "float32", False),
    ("chameleon-34b", "bfloat16", True),
    ("chameleon-34b", "float32", False),
    ("mistral-large-123b", "bfloat16", False),
    ("mistral-large-123b", "float32", False),
])
def test_serve_reckoning_on_an_80_gb_card(arch, dtype, fits):
    cfg = get_config(arch).scaled(dtype=memory.DTYPES[dtype])
    need = memory.serve_bytes(cfg, BATCH, MAX_LEN)
    # The parameters, their bf16 copies where they are f32, and the KV
    # cache (L, B, S, KH, Dh) for k and v in bf16.
    copies = 2 * cfg.param_count() if dtype == "float32" else 0
    kv = 2 * cfg.n_layers * BATCH * MAX_LEN * cfg.n_kv_heads * 128 * 2
    assert need == memory.param_bytes(cfg) + copies + kv
    if fits:
        memory.refuse_unless_fits(cfg, need, CARD_FREE)
        return
    with pytest.raises(SystemExit, match=(
            rf"{arch} does not fit: .*"
            rf"{memory.param_bytes(cfg) / 1e9:.1f} GB of {dtype} parameters"
            rf".*80\.0 GB are free")):
        memory.refuse_unless_fits(cfg, need, CARD_FREE)


def test_serve_reckoning_counts_the_cast_copies_and_the_ssm_state():
    cfg = get_config("mamba2-1.3b")           # f32 parameters, bf16 compute
    n = cfg.param_count()
    state = cfg.n_layers * BATCH * 4 * (
        (cfg.conv_width - 1) * (cfg.ssm_heads * cfg.ssm_head_dim
                                + 2 * cfg.ssm_state)
        + cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim)
    assert memory.serve_bytes(cfg, BATCH, MAX_LEN) == 4 * n + 2 * n + state


@pytest.mark.parametrize("arch,dtype,gb", [
    ("gemma3-1b", "float32", 20.83),
    ("deepseek-coder-33b", "bfloat16", 400.13),
])
def test_train_reckoning_counts_params_grads_and_f32_moments(arch, dtype, gb):
    cfg = get_config(arch).scaled(dtype=memory.DTYPES[dtype])
    need = memory.train_bytes(cfg)
    assert round(need / 1e9, 2) == gb
    if need < CARD_FREE:
        memory.refuse_unless_fits(cfg, need, CARD_FREE)
    else:
        with pytest.raises(SystemExit, match=f"{arch} does not fit"):
            memory.refuse_unless_fits(cfg, need, CARD_FREE)


def test_serve_launcher_refuses_before_allocating(monkeypatch):
    from repro_torch.launch import serve as launch_serve

    def no_build(*args, **kwargs):
        raise AssertionError("built a model that does not fit")

    monkeypatch.setattr(launch_serve, "free_bytes", lambda dev: CARD_FREE)
    monkeypatch.setattr(launch_serve, "build", no_build)
    with pytest.raises(SystemExit, match=r"245\.2 GB of bfloat16"):
        launch_serve.main(["--arch", "mistral-large-123b", "--dtype",
                           "bfloat16", "--device", "cpu"])
    with pytest.raises(SystemExit, match="decoder-only"):
        launch_serve.main(["--arch", "whisper-base", "--dtype", "bfloat16",
                           "--device", "cpu"])


# ------------------------------------------------- the multi-card launchers
def test_distributed_without_the_launchers_environment_raises(monkeypatch,
                                                              tmp_path):
    from repro_torch.launch.train import main
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="launcher's environment"):
        main(["--arch", ARCH, "--smoke", "--device", "cpu", "--distributed",
              "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_mistral_bf16_is_refused_on_one_card_and_admitted_on_four():
    from repro_torch.dist.sharding import Policy, serve_policy
    from repro_torch.launch.mesh import Mesh

    cfg = get_config("mistral-large-123b").scaled(dtype=torch.bfloat16)
    policy = serve_policy(False)
    one = Mesh(("data", "model"), (1, 1))
    four = Mesh(("data", "model"), (4, 1))
    # The launcher's defaults: 4 prompts of 16, 16 new tokens.
    need1 = memory.serve_bytes(cfg, 4, 40, one, policy)
    need4 = memory.serve_bytes(cfg, 4, 40, four, policy)
    assert need1 == memory.serve_bytes(cfg, 4, 40)
    with pytest.raises(SystemExit, match="mistral-large-123b does not fit"):
        memory.refuse_unless_fits(cfg, need1, CARD_FREE)
    memory.refuse_unless_fits(cfg, need4, CARD_FREE)
    # 61.3 GB of weight shards, a gathered layer of 1.38 B parameters in
    # bf16 (wq, wk, wv, wo and the MLP), and one row's KV cache.
    shards = memory.local_param_count(cfg, four, policy) * 2
    assert round(shards / 1e9, 1) == 61.3
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    layer = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
             + 3 * d * f + 2 * d)
    assert memory.gathered_count(cfg, four, policy) == layer
    assert round(layer / 1e9, 2) == 1.38
    kv = 2 * cfg.n_layers * 1 * 40 * cfg.n_kv_heads * hd * 2
    assert need4 == shards + 2 * layer + kv
    # Training state over four ranks: parameters, gradients, f32 moments.
    n4 = memory.local_param_count(cfg, four, Policy())
    assert memory.train_bytes(cfg, four, Policy()) == (
        2 * n4 * 2 + 2 * n4 * 4 + 2 * layer)


def test_tp_and_seq_shard_reach_the_policy_as_in_the_reference(
        monkeypatch, tmp_path):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    seen = {}

    class Recording(launch_serve.Engine):
        def __init__(self, model, mesh, policy, params, cfg):
            seen.setdefault("serve", []).append(policy)
            super().__init__(model, mesh, policy, params, cfg)

    class RecordingTrainer(launch_train.Trainer):
        def __init__(self, model, mesh, policy, *args):
            seen.setdefault("train", []).append(policy)
            super().__init__(model, mesh, policy, *args)

    monkeypatch.setattr(launch_serve, "Engine", Recording)
    monkeypatch.setattr(launch_train, "Trainer", RecordingTrainer)
    common = ["--arch", ARCH, "--smoke", "--device", "cpu"]
    for tp in ([], ["--tp"]):
        assert launch_serve.main(common + ["--batch", "1", "--prompt-len",
                                           "4", "--new", "2"] + tp) == 0
    for flags in ([], ["--seq-shard", "--grad-compress",
                       "--microbatches", "2"]):
        assert launch_train.main(common + ["--steps", "1", "--seq-len", "8",
                                           "--global-batch", "2",
                                           "--ckpt-dir",
                                           str(tmp_path / str(len(flags)))]
                                 + flags) == 0
    # The reference launchers' policies (src/repro/launch/serve.py:49-50,
    # src/repro/launch/train.py:62-67).
    want_serve = [shd.Policy().with_logical(heads=(), kv_heads=(),
                                            heads_flat=(), vocab=(), mlp=()),
                  shd.Policy()]
    want_train = [shd.Policy(microbatches=1, grad_compress=False),
                  shd.Policy(microbatches=2, grad_compress=True
                             ).with_logical(seq=("model",))]
    for got, want in zip(seen["serve"] + seen["train"],
                         want_serve + want_train):
        assert (got.microbatches, got.grad_compress, got.fsdp_axes,
                got.logical) == (want.microbatches, want.grad_compress,
                                 want.fsdp_axes, want.logical)
