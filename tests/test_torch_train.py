"""The port's training substrate on the CPU against the JAX package's:
the data pipeline, the learning-rate schedule, one AdamW step, int8
gradient quantization, and the reference trainer's contracts
(tests/test_substrate.py:152-200) run on the port: the loss decreases, a
crash and restart resumes the trajectory, a straggler is detected, grad
compression converges. Then one finite train step per ported smoke
config, and the launcher.

Tolerances: batches byte-equal; schedule within 1e-7 (absolute, the
rates are <= 3e-3); one AdamW step within 1e-6 relative of each leaf's
largest magnitude (measured 6e-8); quantize's int8 payload bit-equal, its
scale and residual within 1 ulp."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.train import grad_compress as ref_gc
from repro.train import optimizer as ref_opt
from repro_torch.ckpt.checkpoint import tree_leaves
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist.sharding import Policy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_train
from repro_torch.train import OptConfig, TrainConfig, Trainer, make_train_fns
from repro_torch.train import grad_compress, optimizer


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them fastest (3x
    here), and keeps step times steady when test workers share the cores,
    which the straggler test's timing needs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- data
def test_batches_are_the_references():
    kw = dict(vocab=97, seq_len=48, global_batch=3, seed=5, mean_doc_len=20)
    mine, theirs = SyntheticLM(DataConfig(**kw)), RefSyntheticLM(
        RefDataConfig(**kw))
    assert mine.entropy_floor() == theirs.entropy_floor()
    for step in range(3):
        a, b = mine.batch(step), theirs.batch(step)
        assert set(a) == set(b) == {"tokens", "targets", "mask"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
    fa, fb = mine.frames_batch(1, 8, 16), theirs.frames_batch(1, 8, 16)
    for k in fa:
        assert fa[k].tobytes() == fb[k].tobytes()


# -------------------------------------------------------------- optimizer
OPT = dict(lr=3e-3, warmup_steps=7, total_steps=40, min_lr_frac=0.1)


def test_schedule_matches_the_reference():
    mine, theirs = OptConfig(**OPT), ref_opt.OptConfig(**OPT)
    steps = np.arange(0, 41, dtype=np.int32)
    want = np.asarray(ref_opt.schedule(theirs, jnp.asarray(steps)))
    got = optimizer.schedule(mine, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert float(optimizer.schedule(mine, 3)) == pytest.approx(
        float(want[3]), abs=1e-7)


def _tree(rng, scale=1.0):
    return {"embed": rng.standard_normal((12, 4)).astype(np.float32) * scale,
            "layers": {"w": rng.standard_normal((3, 4, 5)).astype(np.float32)
                       * scale,
                       "norm": rng.standard_normal((3, 4)).astype(np.float32)
                       * scale},
            "final_norm": rng.standard_normal(4).astype(np.float32) * scale}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # unclipped, clipped
def test_one_adamw_step_matches_the_reference(grad_scale, monkeypatch):
    rng = np.random.default_rng(0)
    params, grads = _tree(rng), _tree(rng, grad_scale)
    m, v = _tree(rng, 0.1), jax.tree.map(np.abs, _tree(rng, 0.01))
    cfg = dict(OPT, weight_decay=0.1, grad_clip=1.0)
    rstate = {"m": m, "v": v, "step": jnp.asarray(4, jnp.int32)}
    rp, rs, rstats = ref_opt.apply(ref_opt.OptConfig(**cfg), params, grads,
                                   rstate)
    # Chunks of 7 elements: every leaf above 7 is updated in pieces.
    monkeypatch.setattr(optimizer, "CHUNK", 7)
    state = {"m": _torch_tree(m), "v": _torch_tree(v),
             "step": torch.tensor(4, dtype=torch.int32)}
    tp = _torch_tree(params)
    p2, s2, stats = optimizer.apply(OptConfig(**cfg), tp, _torch_tree(grads),
                                    state)
    assert p2 is tp and s2["m"] is state["m"]
    assert int(s2["step"]) == 5
    assert float(stats["grad_norm"]) == pytest.approx(
        float(rstats["grad_norm"]), rel=1e-6)
    assert float(stats["lr"]) == pytest.approx(float(rstats["lr"]), rel=1e-6)
    for got, want in ((p2, rp), (s2["m"], rs["m"]), (s2["v"], rs["v"])):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max()


def test_init_state_and_global_norm():
    params = _torch_tree(_tree(np.random.default_rng(1)))
    st = optimizer.init_state(params)
    assert int(st["step"]) == 0 and st["step"].dtype == torch.int32
    assert all(float(t.abs().sum()) == 0 for t in tree_leaves(st["m"]))
    want = np.sqrt(sum(float(np.sum(np.square(t.numpy())))
                       for t in tree_leaves(params)))
    assert float(optimizer.global_norm(params)) == pytest.approx(want,
                                                                 rel=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((7, 33)).astype(np.float32) * 0.3
    e = rng.standard_normal((7, 33)).astype(np.float32) * 1e-3
    rq, rs, rr = ref_gc.quantize(jnp.asarray(g), jnp.asarray(e))
    q, s, r = grad_compress.quantize(torch.from_numpy(g), torch.from_numpy(e))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(rs), maxulp=1)
    np.testing.assert_array_max_ulp(r.numpy(), np.asarray(rr), maxulp=1)
    err = grad_compress.init_error({"a": torch.ones(2, 3)})
    assert err["a"].dtype == torch.float32 and float(err["a"].sum()) == 0


# ----------------------------------------------------------------- trainer
def _small_setup(tmp_path, steps=24, grad_compress_on=False):
    """tests/test_substrate.py's setup on the port."""
    cfg = get_config("yi-6b", smoke=True).scaled(
        remat=False, compute_dtype=torch.float32)
    model = build_train(cfg, device="cpu")
    policy = Policy(microbatches=1, grad_compress=grad_compress_on)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=8, seed=0))
    opt = OptConfig(lr=1e-2, warmup_steps=5, total_steps=steps,
                    weight_decay=0.0)
    tcfg = TrainConfig(steps=steps, ckpt_dir=str(tmp_path), ckpt_every=8,
                       seed=0)
    return Trainer(model, make_host_mesh(), policy, opt, data, tcfg)


def test_trainer_loss_decreases(tmp_path):
    out = _small_setup(tmp_path / "a", steps=30).run()
    losses = [l for _, l in out["losses"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3
    assert out["final_step"] == 30


def test_trainer_crash_restart_resumes_trajectory(tmp_path):
    ref_losses = dict(_small_setup(tmp_path / "ref", steps=20).run()["losses"])
    out1 = _small_setup(tmp_path / "crash", steps=20).run(crash_at=12)
    assert out1["crashed_at"] == 12
    tr2 = _small_setup(tmp_path / "crash", steps=20)
    assert tr2.ckpt.latest_step() == 8
    resumed = dict(tr2.run()["losses"])
    assert min(resumed) == 8
    for s in range(10, 20):
        assert resumed[s] == pytest.approx(ref_losses[s], rel=1e-4), s


def test_trainer_straggler_detection(tmp_path):
    tr = _small_setup(tmp_path / "strag", steps=14)
    orig = tr.data.batch

    def slow_batch(step):
        if step == 9:
            time.sleep(1.0)
        return orig(step)

    tr.data.batch = slow_batch
    out = tr.run()
    assert any(s == 9 for s, _, _ in out["straggler_events"]), \
        f"straggler at step 9 not detected: {out['straggler_events']}"


def test_trainer_grad_compress_converges(tmp_path):
    out = _small_setup(tmp_path / "gc", steps=30, grad_compress_on=True).run()
    losses = [l for _, l in out["losses"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3
    assert "err" in out["state"]


def test_trainer_restores_into_a_state_that_trains(tmp_path):
    tr = _small_setup(tmp_path / "r", steps=4)
    tr.run()
    tr2 = _small_setup(tmp_path / "r", steps=6)
    state, step = tr2._initial_state()
    assert step == 4 and int(state["opt"]["step"]) == 4
    assert all(p.requires_grad and p.device.type == "cpu"
               for p in tree_leaves(state["params"]))
    assert tr2.run()["final_step"] == 6


# ------------------------------------------------------- every smoke arch
TRAINABLE = [a for a in ARCH_NAMES if get_config(a).family != "encdec"]


def test_every_ported_family_is_listed():
    assert {get_config(a).family for a in TRAINABLE} == {
        "dense", "vlm", "moe", "ssm", "hybrid"}


@pytest.mark.parametrize("arch", TRAINABLE)
def test_one_train_step_per_smoke_arch(arch):
    cfg = get_config(arch, smoke=True)            # bf16 compute, remat on
    init, step = make_train_fns(build_train(cfg, device="cpu"),
                                make_host_mesh(), Policy(),
                                OptConfig(warmup_steps=1))
    state = init(0)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                   global_batch=2)).batch(0)
    before = [p.detach().clone() for p in tree_leaves(state["params"])]
    state, m = step(state, batch)
    loss = m["loss"].item()
    assert np.isfinite(loss) and np.isfinite(m["grad_norm"].item())
    assert abs(loss - np.log(cfg.vocab)) < 2.5
    after = tree_leaves(state["params"])
    assert all(bool(torch.isfinite(p).all()) for p in after)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


# ---------------------------------------------------------------- launcher
def test_launcher_smoke_on_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    assert main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                 "--steps", "6", "--seq-len", "32", "--global-batch", "2",
                 "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[train] zamba2-2.7b on cpu: step 6 loss" in out
    assert sorted(p.name for p in tmp_path.iterdir())[-1] == \
        "step_00000006.npz"
    with pytest.raises(NotImplementedError):
        main(["--arch", "whisper-base", "--smoke", "--device", "cpu",
              "--ckpt-dir", str(tmp_path / "w")])
