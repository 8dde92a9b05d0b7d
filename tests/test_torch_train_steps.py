"""The port's train step against the reference's jitted step on the CPU,
from the same converted state (``convert.train_state_from_jax``) on the
same batches: yi-6b and zamba2 smoke in f32 with remat off, 10 steps with
1 and 2 microbatches, 3 steps with int8 gradient compression. Losses,
grad norms and learning rates within 1e-5 relative (measured: 4.7e-7 at
most over 10 steps). With compression an element of g + err can lie on a
rounding edge of the int8 grid, where the two f32 computations round it
to neighbouring steps: the grad norm is then held within 1e-4 (measured
2.4e-5), the loss still within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import DataConfig, SyntheticLM
from repro.dist import sharding as ref_shd
from repro.launch.mesh import make_host_mesh
from repro.models import build as ref_build
from repro.train import OptConfig as RefOptConfig
from repro.train import make_train_fns as ref_make_train_fns
from repro_torch.ckpt.checkpoint import tree_leaves
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.dist.sharding import Policy
from repro_torch.launch.mesh import make_host_mesh as host_mesh
from repro_torch.models import build_train
from repro_torch.train import OptConfig, make_train_fns

RTOL = 1e-5
COMPRESSED_NORM_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them fastest (3x
    here), and keeps step times steady when test workers share the cores,
    which the straggler test's timing needs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,microbatches,compress,steps", [
    ("yi-6b", 1, False, 10), ("yi-6b", 2, False, 10),
    ("zamba2-2.7b", 1, False, 10), ("zamba2-2.7b", 2, False, 10),
    ("yi-6b", 1, True, 3), ("zamba2-2.7b", 2, True, 3),
])
def test_steps_match_the_reference(arch, microbatches, compress, steps):
    rcfg = ref_get_config(arch, smoke=True).scaled(
        remat=False, compute_dtype=jnp.float32)
    cfg = get_config(arch, smoke=True).scaled(remat=False,
                                              compute_dtype=torch.float32)
    opt = dict(lr=1e-2, warmup_steps=3, total_steps=steps)
    mesh = make_host_mesh()
    rinit, rmake_step, _ = ref_make_train_fns(
        ref_build(rcfg), mesh,
        ref_shd.Policy(microbatches=microbatches, grad_compress=compress),
        RefOptConfig(**opt))
    rstate = rinit(jax.random.PRNGKey(0))
    state = train_state_from_jax(cfg, jax.tree.map(np.asarray, rstate))
    assert ("err" in state) == compress
    assert int(state["opt"]["step"]) == 0
    assert all(p.requires_grad for p in tree_leaves(state["params"]))
    _, step = make_train_fns(build_train(cfg, device="cpu"), host_mesh(),
                             Policy(microbatches, compress), OptConfig(**opt))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4))
    rstep = rmake_step(jax.eval_shape(lambda: rstate),
                       jax.eval_shape(lambda: data.batch(0)))
    with mesh:
        for i in range(steps):
            batch = data.batch(i)
            rstate, rm = rstep(rstate, batch)
            state, m = step(state, batch)
            for key in ("loss", "grad_norm", "lr"):
                tol = (COMPRESSED_NORM_RTOL if compress and key == "grad_norm"
                       else RTOL)
                assert m[key].item() == pytest.approx(float(rm[key]),
                                                      rel=tol), (i, key)
    assert int(state["opt"]["step"]) == steps
    if compress:
        for e, re in zip(tree_leaves(state["err"]),
                         jax.tree.leaves(rstate["err"])):
            assert e.shape == re.shape and bool(torch.isfinite(e).all())


def test_a_batch_that_does_not_split_raises():
    cfg = get_config("yi-6b", smoke=True).scaled(compute_dtype=torch.float32)
    init, step = make_train_fns(build_train(cfg, device="cpu"), host_mesh(),
                                Policy(3), OptConfig())
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=8,
                                   global_batch=4)).batch(0)
    with pytest.raises(ValueError, match="microbatches"):
        step(init(0), batch)
