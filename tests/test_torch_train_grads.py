"""Gradients of the port's training path on the CPU.

K5 and K6 reach training through ``torch.autograd.Function``s whose
backward recomputes the plain version (the reference's custom_vjps,
``src/repro/kernels/ops.py:55-107``). On the CPU their forward is the
plain version too, so the plumbing is held here: the Functions give the
gradients of autograd through the plain versions, bit for bit. Then the
loss and every gradient leaf of six smoke configs (two MoE, their aux
loss included) in f32 against ``jax.value_and_grad`` of the reference's
loss, with the reference's weights carried over by ``convert``: loss
within 1e-5 relative, each leaf within 1e-5 of its largest magnitude
(measured on the four others: 3.3e-7 and 2.2e-6 at most). The ``unbind``
split and remat must not change a gradient bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import build as ref_build
from repro_torch.ckpt.checkpoint import tree_leaves
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import build_train, transformer
from repro_torch.train.train_step import batch_to

LOSS_RTOL = 1e-5
LEAF_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them fastest (3x
    here), and keeps step times steady when test workers share the cores,
    which the straggler test's timing needs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf_params(tree):
    for p in tree_leaves(tree):
        p.requires_grad_(True)
    return tree


def _grads_through(fn, inputs, g):
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    return out, torch.autograd.grad(out, ins, g)


ATTN_CASES = [
    (2, 4, 4, 24, 16, True, None, torch.float32),      # causal MHA
    (2, 8, 2, 33, 16, True, None, torch.float32),      # GQA, ragged S
    (1, 4, 1, 40, 32, True, 8, torch.float32),         # MQA, windowed
    (1, 4, 4, 20, 16, False, None, torch.float32),     # bidirectional
    (2, 4, 2, 24, 16, True, None, torch.bfloat16),     # bf16 compute
]


@pytest.mark.parametrize("b,h,kh,s,d,causal,window,dtype", ATTN_CASES)
def test_attention_fn_gradients_are_the_plain_versions(b, h, kh, s, d, causal,
                                                       window, dtype):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype)
               for shape in ((b, h, s, d), (b, kh, s, d), (b, kh, s, d)))
    g = torch.randn((b, h, s, d), generator=gen).to(dtype)
    ops.reset_launches()
    got, got_g = _grads_through(
        lambda q, k, v: ops.attention(q, k, v, causal=causal, window=window),
        (q, k, v), g)
    want, want_g = _grads_through(
        lambda q, k, v: ref.attention_ref(q, k, v, causal=causal,
                                          window=window), (q, k, v), g)
    assert got.grad_fn is not None
    assert type(got.grad_fn).__name__ == "_AttentionFnBackward"
    assert torch.equal(got, want)
    for a, w in zip(got_g, want_g):
        assert a.dtype == dtype and torch.equal(a, w)
    assert ops.launches()["flash_attention"] == 0   # CPU: no kernel


#: (B, S, H, P, N, chunk, the plain version the CPU runs)
SSD_CASES = [
    (2, 128, 3, 8, 4, 64, "chunked"),    # S a multiple of chunk
    (2, 100, 3, 8, 4, 64, "scan"),       # ragged S
    (1, 32, 2, 16, 8, 32, "scan"),       # S == chunk
]


def _ssd_inputs(b, s, h, p, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen))
    a = -torch.exp(torch.randn(h, generator=gen) * 0.3)
    bm = torch.randn((b, s, n), generator=gen) * 0.5
    cm = torch.randn((b, s, n), generator=gen) * 0.5
    d = torch.randn(h, generator=gen)
    return (x, dt * 0.1, a, bm, cm, d), torch.randn((b, s, h, p),
                                                   generator=gen)


@pytest.mark.parametrize("b,s,h,p,n,chunk,form", SSD_CASES)
def test_ssd_fn_gradients_are_the_plain_versions(b, s, h, p, n, chunk, form):
    args, g = _ssd_inputs(b, s, h, p, n)
    if form == "chunked":
        def plain(*a):
            return ref.ssd_chunked_ref(*a, chunk=chunk)
    else:
        plain = ref.ssd_ref
    got, got_g = _grads_through(
        lambda *a: ops.ssd(*a, chunk=chunk), args, g)
    want, want_g = _grads_through(plain, args, g)
    assert type(got.grad_fn).__name__ == "_SsdFnBackward"
    assert torch.equal(got, want)
    assert len(got_g) == 6
    for a, w in zip(got_g, want_g):
        assert torch.equal(a, w)


def test_ssd_fn_skips_inputs_without_grad_and_state_is_forward_only():
    args, g = _ssd_inputs(1, 64, 2, 8, 4)
    x = args[0].clone().requires_grad_(True)
    y = ops.ssd(x, *args[1:], chunk=32)
    (gx,) = torch.autograd.grad(y, x, g)
    want = ref.ssd_chunked_ref(x, *args[1:], chunk=32)
    assert torch.equal(gx, torch.autograd.grad(want, x, g)[0])
    with pytest.raises(ValueError, match="forward-only"):
        ops.ssd(x, *args[1:], chunk=32, return_state=True)
    with torch.no_grad():
        y, st = ops.ssd(x, *args[1:], chunk=32, return_state=True)
    assert y.grad_fn is None and st.shape == (1, 2, 4, 8)


# ------------------------------------------------------- the model's grads
ARCHS = ["zamba2-2.7b", "mamba2-1.3b", "yi-6b", "gemma3-1b",
         "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]


def _pair(arch, remat=False):
    rcfg = ref_get_config(arch, smoke=True).scaled(
        remat=False, compute_dtype=jnp.float32)
    cfg = get_config(arch, smoke=True).scaled(
        remat=remat, compute_dtype=torch.float32)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    batch = RefSyntheticLM(RefDataConfig(vocab=cfg.vocab, seq_len=32,
                                         global_batch=2)).batch(0)
    return rmodel, rparams, cfg, batch


def _port_grads(cfg, rparams, batch):
    params = _leaf_params(params_from_jax(cfg, jax.tree.map(np.asarray,
                                                            rparams)))
    loss = build_train(cfg, device="cpu").loss(params, batch_to(batch, "cpu"))
    return loss, torch.autograd.grad(loss, tree_leaves(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    rmodel, rparams, cfg, batch = _pair(arch)
    rloss, rgrads = jax.jit(jax.value_and_grad(rmodel.loss))(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_grads(cfg, rparams, batch)
    assert loss.item() == pytest.approx(float(rloss), rel=LOSS_RTOL)
    rleaves = jax.tree.leaves(rgrads)
    assert len(grads) == len(rleaves)
    if cfg.tie_embeddings:       # gemma3: the head reads embed too
        assert "head" not in build_train(cfg, "cpu").init(0)
    for g, r in zip(grads, rleaves):
        r = np.asarray(r)
        assert g.shape == r.shape
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(g.numpy() - r).max()) <= LEAF_TOL * scale


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "yi-6b",
                                  "qwen3-moe-30b-a3b"])
def test_remat_gives_the_same_gradients(arch, monkeypatch):
    _, rparams, cfg, batch = _pair(arch)
    loss, grads = _port_grads(cfg, rparams, batch)
    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rloss, rgrads = _port_grads(cfg.scaled(remat=True), rparams, batch)
    n_sites = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    assert len(calls) == cfg.n_layers + n_sites
    assert torch.equal(loss, rloss)
    for a, b in zip(grads, rgrads):
        assert torch.equal(a, b)


def _indexed(tree, i):
    """Layer ``i``'s parameters by indexing each stacked leaf."""
    return {k: _indexed(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "yi-6b"])
def test_unbind_split_gives_the_indexed_gradients(arch, monkeypatch):
    _, rparams, cfg, batch = _pair(arch, remat=True)
    loss, grads = _port_grads(cfg, rparams, batch)
    monkeypatch.setattr(
        transformer, "split_layers",
        lambda tree, n: [_indexed(tree, i) for i in range(n)])
    iloss, igrads = _port_grads(cfg, rparams, batch)
    assert torch.equal(loss, iloss)
    for a, b in zip(grads, igrads):
        assert torch.equal(a, b)


def test_split_layers_are_views_of_one_unbind():
    stacked = {"a": torch.arange(6.0).reshape(3, 2).requires_grad_(True),
               "b": {"c": torch.ones(3, 4, requires_grad=True)}}
    parts = transformer.split_layers(stacked, 3)
    assert len(parts) == 3
    assert torch.equal(parts[2]["a"], torch.tensor([4.0, 5.0]))
    assert parts[0]["b"]["c"].shape == (4,)
    assert type(parts[1]["a"].grad_fn).__name__ == "UnbindBackward0"
