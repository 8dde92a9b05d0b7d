"""The port's multi-rank path on the CPU: spawned gloo ranks on meshes
(1, 2), (2, 1) and (2, 2) against one process and against the JAX
package, at smoke size in f32.

* Serving: ``Engine(model, mesh, Policy(), ...)`` tokens equal to the
  one-process engine's and to the reference ``Engine``'s on
  ``make_host_mesh()``; prefill logits (gathered over the vocabulary and
  the rows) within rtol 1e-5 of one process's.
* Training: one step of ``make_train_fns(model, mesh, policy, opt)``
  under the default policy, with the sequence sharded over ``model``
  (``--seq-shard``) and with ``grad_compress``: the loss, the grad norm,
  the first moment (the reduced, clipped gradient times 1 - b1) and every
  updated parameter within 1e-5 of one process's (of each leaf's scale).
  AdamW's first step moves a parameter by about ``lr * g / (|g| + eps)``,
  whose slope in g is ``eps / (|g| + eps)^2``: where |g| is small, a
  summation-order difference in g (f32 cancellation in the reduction)
  moves the parameter by more than 1e-5. Elements whose first moment is
  under 1% of their leaf's largest are held through the first moment
  alone. Under ``grad_compress`` an element of g + err can
  lie on a rounding edge of the int8 grid (tests/test_torch_train_steps.py
  meets the same against the reference): at most one in a thousand of a
  leaf's first moments may then differ by exactly one quantization step.
* MoE groups in the global order: ``moe_ffn`` on ranks whose rows would
  form other groups (600 local tokens against 1024-token global groups
  and a ragged tail, gathered) and on ranks that hold whole groups (1024
  local tokens, routed locally) equals one process's: the output, the aux
  loss and the aux loss's gradient in the router.
* Checkpoints: written by two ranks, restored on one, and the other way
  round, to the losses of an uninterrupted run.
* ``compressed_psum`` on four ranks against the reference's under
  ``jax.shard_map`` on four forced host devices (a subprocess), within
  1e-6 of the scale.

Each spawned group has its own 120 s timeout and a ``FileStore`` in
``tmp_path``. The worker functions below run in the spawned ranks and
import nothing of JAX."""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import tree_leaves
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import Policy
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import build, build_train
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import OptConfig, TrainConfig, Trainer, make_train_fns
from repro_torch.train.train_step import (make_decode_fn, make_prefill_fn,
                                          tree_paths)

ROOT = Path(__file__).resolve().parent.parent
SERVE_ARCHS = ("yi-6b", "gemma3-1b", "zamba2-2.7b", "qwen3-moe-30b-a3b",
               "mamba2-1.3b")
TRAIN_ARCHS = ("yi-6b", "zamba2-2.7b", "qwen3-moe-30b-a3b", "whisper-base")
POLICIES = {"default": Policy(),
            "seq_shard": Policy().with_logical(seq=("model",)),
            "grad_compress": Policy(grad_compress=True)}
BATCH, PROMPT, NEW, MAX_LEN = 4, 12, 6, 24
SEQ = 16
RTOL = 1e-5
MESH_SHAPES = [(1, 2), (2, 1), (2, 2)]
#: MoE sequence lengths of a 4-row batch: 300 (groups that the ranks'
#: rows would not form) and 512 (each data rank holds whole groups).
MOE_SEQS = (300, 512)
OPT = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)


def _cfg(arch):
    return get_config(arch, smoke=True).scaled(compute_dtype=torch.float32,
                                               remat=False)


def _prompts(cfg):
    return np.random.default_rng(3).integers(
        1, cfg.vocab, size=(BATCH, PROMPT)).astype(np.int32)


def _batch(cfg, step=0):
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                   global_batch=BATCH)).batch(step)
    if cfg.family == "encdec":
        batch["frames"] = _frames(cfg)
    return batch


def _frames(cfg):
    return np.random.default_rng(4).standard_normal(
        (BATCH, 20, cfg.d_model)).astype(np.float32)


def encdec_steps(model, plan=None):
    """whisper's prefill on stub frames and three greedy decode steps: the
    whole batch's logits of each (gathered over the vocabulary and rows
    on a mesh)."""
    frames = torch.as_tensor(_frames(model.cfg))
    toks = torch.as_tensor(_prompts(model.cfg)[:, :4].astype(np.int64))
    if plan is not None:
        frames, toks = plan.batch_local(frames), plan.batch_local(toks)
    logits, cache = model.prefill(frames, toks, MAX_LEN)
    out = []
    for _ in range(3):
        with torch.inference_mode():
            whole = logits if plan is None else plan.gather_rows(
                plan.gather_logits(logits), BATCH)
            tok = (torch.argmax(logits[:, -1], -1)[:, None] if plan is None
                   else plan.greedy(logits))
        out.append(whole.numpy())
        logits, cache = model.decode_step(cache, tok.long())
    return out


def _whole(mesh, plan, t, path):
    """A parameter shard gathered to the whole leaf."""
    for d, axes in enumerate(plan.specs[path]):
        t = col.all_gather(t, mesh, axes, d)
    return t


# ------------------------------------------------------------ in the ranks
def serve_and_train(rank, world, shape, ckpt_dirs):
    """Everything one mesh shape runs: tokens and prefill logits of each
    serve arch, one train step per train arch and policy, the MoE group
    rule, and (on (2, 1)) the checkpoint round trips."""
    torch.set_num_threads(1)
    mesh = Mesh.distributed(shape, ("data", "model"))
    out = {"serve": {}, "train": {}}
    for arch in SERVE_ARCHS:
        cfg = _cfg(arch)
        model = build(cfg, seed=0, device="cpu", mesh=mesh, policy=Policy())
        eng = Engine(model, mesh, Policy(), None,
                     ServeConfig(max_new_tokens=NEW, max_len=MAX_LEN))
        tokens = eng.generate(_prompts(cfg))
        plan = model.plan
        toks = torch.as_tensor(_prompts(cfg).astype(np.int64))
        logits, _ = model.prefill(plan.batch_local(toks), MAX_LEN)
        with torch.inference_mode():
            logits = plan.gather_rows(plan.gather_logits(logits), BATCH)
        out["serve"][arch] = (tokens, logits.numpy())
    model = build(_cfg("whisper-base"), seed=0, device="cpu", mesh=mesh,
                  policy=Policy())
    out["encdec"] = encdec_steps(model, model.plan)
    model = build(_cfg("yi-6b"), seed=0, device="cpu", mesh=mesh,
                  policy=Policy())
    out["step_fns"] = step_fns(model, mesh)
    for arch in TRAIN_ARCHS:
        cfg = _cfg(arch)
        for name, pol in POLICIES.items():
            model = build_train(cfg, "cpu", mesh=mesh, policy=pol)
            init, step = make_train_fns(model, mesh, pol, OPT)
            state = init(0)
            state, metrics = step(state, _batch(cfg))
            params = state["params"]
            paths = tree_paths(params)
            whole = [[_whole(mesh, model.plan, t.detach(), p).numpy()
                      for t, p in zip(tree_leaves(tree), paths)]
                     for tree in (params, state["opt"]["m"])]
            out["train"][(arch, name)] = (float(metrics["loss"]),
                                          float(metrics["grad_norm"]), *whole)
    out["moe"] = moe_groups(mesh)
    if ckpt_dirs:
        out["ckpt"] = ckpt_round_trips(mesh, *ckpt_dirs)
    return out if rank == 0 else None


def step_fns(model, mesh=None):
    """``make_prefill_fn`` and ``make_decode_fn`` (one step on the
    prefill's greedy tokens): the whole batch's logits of each."""
    plan = model.plan
    prefill = make_prefill_fn(model, mesh, Policy())
    decode = make_decode_fn(model, mesh, Policy())
    toks = torch.as_tensor(_prompts(model.cfg).astype(np.int64))
    out = []
    logits, cache = prefill({"tokens": toks})
    with torch.inference_mode():
        for _ in range(2):
            whole = logits if plan is None else plan.gather_rows(
                plan.gather_logits(logits), BATCH)
            out.append(whole.numpy())
            if len(out) == 2:
                break
            tok = torch.argmax(whole[:, -1], -1)[:, None]
            logits, cache = decode(cache, tok)
    return out


def _moe_inputs(cfg, seq):
    return torch.as_tensor(np.random.default_rng(5).standard_normal(
        (4, seq, cfg.d_model)).astype(np.float32))


def moe_groups(mesh):
    """``moe_ffn`` on this rank's rows of a 4 x S batch, per S in
    MOE_SEQS: the whole batch's output (gathered), its aux loss, the aux
    loss's gradient in the router (summed over the ranks' shares) and
    whether the rank routed its own rows alone."""
    from repro_torch.models.common import activation_sharding
    from repro_torch.models.moe import GROUP_SIZE, moe_ffn

    cfg = _cfg("qwen3-moe-30b-a3b")
    model = build(cfg, seed=0, device="cpu", mesh=mesh, policy=Policy())
    plan = model.plan
    p = {k: v[0] for k, v in model.run_params["layers"]["moe"].items()}
    with torch.no_grad(), activation_sharding(plan):
        p = plan.gather(p, ("layers", "moe"))
    out = {}
    for seq in MOE_SEQS:
        router = p["router"].detach().clone().requires_grad_(True)
        mine = plan.batch_local(_moe_inputs(cfg, seq))
        with activation_sharding(plan):
            local = plan.moe_tokens(mine, GROUP_SIZE)[2]
            y, aux = moe_ffn(cfg, {**p, "router": router}, mine)
            grad, = torch.autograd.grad(aux / mesh.size, router)
            y = plan.gather_rows(y.detach(), 4)
        grad = col.psum_scalar(grad, mesh, mesh.axis_names)
        out[seq] = (y.numpy(), float(aux), grad.numpy(), local)
    return out


def _trainer(model, mesh, cfg, ckpt_dir, steps):
    return Trainer(model, mesh, Policy(), OPT,
                   SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                          global_batch=BATCH)),
                   TrainConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=1))


def ckpt_round_trips(mesh, written_by_two, written_by_one):
    """Two steps saved by these ranks into ``written_by_two``; the one
    process's two-step checkpoint in ``written_by_one`` resumed here to
    step 4."""
    cfg = _cfg("yi-6b")
    model = build_train(cfg, "cpu", mesh=mesh, policy=Policy())
    _trainer(model, mesh, cfg, written_by_two, 2).run()
    resumed = _trainer(model, mesh, cfg, written_by_one, 4).run()
    return resumed["losses"]


def psum_ranks(rank, world):
    """The port's ``compressed_psum`` over a (4, 1) mesh's data axis."""
    from repro_torch.train.grad_compress import compressed_psum

    torch.set_num_threads(1)
    mesh = Mesh.distributed((4, 1), ("data", "model"))
    g, e = _psum_inputs(rank)
    out, new_e = compressed_psum({"a": g[0], "b": g[1]},
                                 {"a": e[0], "b": e[1]}, mesh, ("data",))
    return ({k: v.numpy() for k, v in out.items()},
            {k: v.numpy() for k, v in new_e.items()})


def _psum_inputs(rank):
    rng = np.random.default_rng(100 + rank)
    g = [torch.as_tensor(rng.standard_normal(s).astype(np.float32) * 3)
         for s in ((5, 7), (11,))]
    e = [torch.as_tensor(rng.standard_normal(s).astype(np.float32) * 0.01)
         for s in ((5, 7), (11,))]
    return g, e


# --------------------------------------------------------------- the tests
def _one_process_serve(arch):
    cfg = _cfg(arch)
    model = build(cfg, seed=0, device="cpu")
    tokens = Engine(model, make_host_mesh(), Policy(), None,
                    ServeConfig(max_new_tokens=NEW, max_len=MAX_LEN)
                    ).generate(_prompts(cfg))
    logits, _ = model.prefill(torch.as_tensor(
        _prompts(cfg).astype(np.int64)), MAX_LEN)
    return model, tokens, logits.numpy()


def _one_process_train(arch, pol):
    cfg = _cfg(arch)
    model = build_train(cfg, "cpu")
    init, step = make_train_fns(model, make_host_mesh(), pol, OPT)
    state, metrics = step(init(0), _batch(cfg))
    return (float(metrics["loss"]), float(metrics["grad_norm"]),
            *[[t.detach().numpy() for t in tree_leaves(tree)]
              for tree in (state["params"], state["opt"]["m"])])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread runs them fastest, and the
    spawned ranks share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_process():
    serve = {a: _one_process_serve(a) for a in SERVE_ARCHS}
    train = {(a, n): _one_process_train(a, p) for a in TRAIN_ARCHS
             for n, p in POLICIES.items()}
    return serve, train


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    root = tmp_path_factory.mktemp("ranks")
    by_one = str(root / "ckpt_by_one")
    cfg = _cfg("yi-6b")
    _trainer(build_train(cfg, "cpu"), make_host_mesh(), cfg, by_one, 2).run()

    def group(shape):
        dirs = ((str(root / "ckpt_by_two"), by_one) if shape == (2, 1)
                else ())
        return spawn_ranks(
            serve_and_train, shape[0] * shape[1], (shape, dirs),
            store_dir=str(root / f"store_{shape[0]}x{shape[1]}"),
            timeout=120)[0]

    # The three groups run at once, each with its own store and timeout.
    with ThreadPoolExecutor(3) as pool:
        out = dict(zip(MESH_SHAPES, pool.map(group, MESH_SHAPES)))
    out["root"] = root
    return out



@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_engine_tokens_equal_one_process_and_the_reference(
        ranks, one_process, arch, shape):
    model, tokens, logits = one_process[0][arch]
    got_tokens, got_logits = ranks[shape]["serve"][arch]
    np.testing.assert_array_equal(got_tokens, tokens)
    np.testing.assert_allclose(got_logits, logits, rtol=RTOL,
                               atol=RTOL * np.abs(logits).max())
    if shape == (2, 2):
        _reference_tokens_equal(arch, model, tokens)


def _reference_tokens_equal(arch, model, tokens):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.dist import sharding as ref_shd
    from repro.launch.mesh import make_host_mesh as ref_mesh
    from repro.models import build as ref_build
    from repro.serve import Engine as RefEngine
    from repro.serve import ServeConfig as RefServeConfig

    rcfg = ref_get_config(arch, smoke=True).scaled(
        remat=False, compute_dtype=jnp.float32)
    rparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), model.params)
    reng = RefEngine(ref_build(rcfg), ref_mesh(), ref_shd.Policy(), rparams,
                     RefServeConfig(max_new_tokens=NEW, max_len=MAX_LEN))
    np.testing.assert_array_equal(reng.generate(_prompts(model.cfg)), tokens)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_prefill_and_decode_fns_equal_one_process(ranks, shape):
    """``make_prefill_fn`` / ``make_decode_fn`` on the mesh against the
    same functions on a (1, 1) mesh, which are the model's own."""
    model = build(_cfg("yi-6b"), seed=0, device="cpu")
    want = step_fns(model, make_host_mesh())
    prompts = torch.as_tensor(_prompts(model.cfg).astype(np.int64))
    np.testing.assert_array_equal(want[0],
                                  model.prefill(prompts, SEQ)[0].numpy())
    for got, w in zip(ranks[shape]["step_fns"], want):
        np.testing.assert_allclose(got, w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max())


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_encdec_decode_equals_one_process(ranks, shape):
    """whisper-base on the mesh: its MLP stacks split along the layer dim
    (the reference's rule reads them as expert weights), gathered before
    the layer loop; prefill and decode logits within rtol 1e-5."""
    want = encdec_steps(build(_cfg("whisper-base"), seed=0, device="cpu"))
    for got, w in zip(ranks[shape]["encdec"], want):
        np.testing.assert_allclose(got, w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max())


@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_equals_one_process(ranks, one_process, arch, policy,
                                       shape):
    loss, gnorm, params, moment = one_process[1][(arch, policy)]
    got_loss, got_gnorm, got_params, got_moment = \
        ranks[shape]["train"][(arch, policy)]
    assert got_loss == pytest.approx(loss, rel=RTOL)
    assert got_gnorm == pytest.approx(gnorm, rel=RTOL)
    assert len(got_params) == len(params) == len(got_moment)
    for got, want, got_m, m in zip(got_params, params, got_moment, moment):
        scale = np.abs(m).max()
        edge = np.abs(got_m - m) > RTOL * scale + RTOL * np.abs(m)
        if policy == "grad_compress" and edge.any():
            # g + err on a rounding edge of the int8 grid: the two
            # reductions' f32 sums round it to neighbouring steps.
            step = scale / 127
            assert edge.sum() <= max(1, 1e-3 * m.size), edge.sum()
            np.testing.assert_allclose(np.abs(got_m - m)[edge], step,
                                       rtol=1e-2)
        else:
            assert not edge.any(), (np.abs(got_m - m).max(), scale)
        steady = (np.abs(m) >= 1e-2 * scale) & ~edge
        np.testing.assert_allclose(got[steady], want[steady], rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("seq", MOE_SEQS)
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_moe_groups_follow_the_global_order(ranks, one_process, shape, seq):
    from repro_torch.models.moe import moe_ffn

    cfg = _cfg("qwen3-moe-30b-a3b")
    model = build(cfg, seed=0, device="cpu")
    p = {k: v[0] for k, v in model.run_params["layers"]["moe"].items()}
    router = p["router"].detach().clone().requires_grad_(True)
    y, aux = moe_ffn(cfg, {**p, "router": router}, _moe_inputs(cfg, seq))
    grad, = torch.autograd.grad(aux, router)
    got_y, got_aux, got_grad, local = ranks[shape]["moe"][seq]
    # 4 x 512 tokens leave each of two data ranks 1024, one whole group.
    assert local == (seq == 512 and shape[0] > 1)
    np.testing.assert_allclose(got_y, y.detach().numpy(), rtol=RTOL,
                               atol=RTOL)
    assert got_aux == pytest.approx(float(aux.detach()), rel=RTOL)
    np.testing.assert_allclose(got_grad, grad.numpy(), rtol=RTOL,
                               atol=RTOL * np.abs(grad.numpy()).max())


def test_checkpoints_cross_between_one_and_two_ranks(ranks):
    cfg = _cfg("yi-6b")
    root = ranks["root"]
    whole = _trainer(build_train(cfg, "cpu"), make_host_mesh(), cfg,
                     str(root / "uninterrupted"), 4).run()["losses"]
    # Written by two ranks after step 2, resumed here on one.
    resumed = _trainer(build_train(cfg, "cpu"), make_host_mesh(), cfg,
                       str(root / "ckpt_by_two"), 4).run()["losses"]
    assert [s for s, _ in resumed] == [2, 3]
    for (s, got), (_, want) in zip(resumed, whole[2:]):
        assert got == pytest.approx(want, rel=RTOL), s
    # Written here after step 2, resumed on two ranks.
    by_two = ranks[(2, 1)]["ckpt"]
    assert [s for s, _ in by_two] == [2, 3]
    for (s, got), (_, want) in zip(by_two, whole[2:]):
        assert got == pytest.approx(want, rel=RTOL), s


_REF_PSUM = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.train.grad_compress import compressed_psum
g = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ("data",))
def f(a, b, ea, eb):
    out, err = compressed_psum({"a": a[0], "b": b[0]},
                               {"a": ea[0], "b": eb[0]}, ("data",))
    return out["a"][None], out["b"][None], err["a"][None], err["b"][None]
res = jax.shard_map(f, mesh=mesh, in_specs=(P("data"),) * 4,
                    out_specs=(P("data"),) * 4)(g["a"], g["b"], g["ea"],
                                                g["eb"])
np.savez(sys.argv[2], *[np.asarray(r) for r in res])
"""


def test_compressed_psum_matches_the_reference_on_four_ranks(tmp_path):
    got = spawn_ranks(psum_ranks, 4, (), store_dir=str(tmp_path / "store"),
                      timeout=120)
    ins = [_psum_inputs(r) for r in range(4)]
    np.savez(tmp_path / "in.npz",
             a=np.stack([i[0][0].numpy() for i in ins]),
             b=np.stack([i[0][1].numpy() for i in ins]),
             ea=np.stack([i[1][0].numpy() for i in ins]),
             eb=np.stack([i[1][1].numpy() for i in ins]))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _REF_PSUM,
                           str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = np.load(tmp_path / "out.npz")
    ra, rb, rea, reb = (ref[f"arr_{i}"] for i in range(4))
    for rank, (out, err) in enumerate(got):
        for k, want in (("a", ra[rank]), ("b", rb[rank])):
            scale = np.abs(want).max()
            np.testing.assert_allclose(out[k], want, rtol=0,
                                       atol=1e-6 * scale)
        for k, want in (("a", rea[rank]), ("b", reb[rank])):
            np.testing.assert_allclose(err[k], want, rtol=0, atol=1e-6)


def test_one_rank_mesh_needs_no_process_group():
    mesh = make_host_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups is None
    x = torch.arange(6.0, requires_grad=True)
    for y in (col.all_gather(x, mesh, "data", 0),
              col.reduce_scatter(x, mesh, "model", 0),
              col.all_reduce(x, mesh, ("data", "model"))):
        assert y is x
    cfg = _cfg("yi-6b")
    assert build(cfg, device="cpu", mesh=mesh).plan is None


def dead_peer(rank, world):
    """Rank 1 leaves without its collective; rank 0's all-reduce over the
    model axis must raise, not hang or fall back."""
    mesh = Mesh.distributed((1, 2), ("data", "model"))
    if rank == 1:
        return None
    col.all_reduce(torch.ones(4), mesh, "model")
    return "returned"


def test_a_failed_collective_raises(tmp_path):
    with pytest.raises(RuntimeError, match="rank 0 of dead_peer failed"):
        spawn_ranks(dead_peer, 2, (), store_dir=str(tmp_path / "store"),
                    timeout=60)


def gloo_on_cuda(rank, world):
    """A CUDA tensor over a gloo group: refused unless the mesh names it."""
    torch.cuda.set_device(0)
    x = torch.ones(4, device="cuda")
    out = {}
    for named in (False, True):
        mesh = Mesh.distributed((1, 2), ("data", "model"),
                                gloo_on_cuda=named)
        try:
            out[named] = float(col.all_reduce(x, mesh, "model").sum())
        except RuntimeError as e:
            out[named] = str(e)
    return out


@pytest.mark.cuda
def test_gloo_carries_cuda_tensors_only_where_named(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for got in spawn_ranks(gloo_on_cuda, 2, (),
                           store_dir=str(tmp_path / "store"), timeout=120):
        assert "gloo_on_cuda=True" in got[False]
        assert got[True] == 8.0
