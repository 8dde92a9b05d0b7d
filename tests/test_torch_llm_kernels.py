"""K5 (attention) and K6 (SSD) of the port, on the CPU, against the JAX
package: the plain versions in ``repro_torch.kernels.ref`` (what the ops
wrappers run on CPU tensors) against the Pallas kernels in interpret mode
and the reference's jnp oracles, on the same numpy inputs.

Tolerances are the reference's own (tests/test_kernels.py): attention
2e-5 in f32 and 2e-2 in bf16, SSD 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention
from repro.kernels.ssd import ssd as pallas_ssd
from repro_torch.kernels import ops, ref

ATTN_SHAPES = [
    (1, 4, 4, 128, 32, True, None),     # MHA causal
    (2, 4, 2, 128, 16, True, None),     # GQA
    (1, 8, 1, 256, 32, True, None),     # MQA, multi k-block
    (1, 4, 4, 128, 32, False, None),    # bidirectional (encoder)
    (1, 4, 2, 256, 32, True, 64),       # sliding window
    (2, 4, 4, 128, 80, True, None),     # zamba2's head_dim
]


def _attn_inputs(b, h, kh, s, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, dh), np.float32),
            rng.standard_normal((b, kh, s, dh), np.float32),
            rng.standard_normal((b, kh, s, dh), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,s,dh,causal,window", ATTN_SHAPES)
def test_attention_plain_matches_pallas_and_oracle(b, h, kh, s, dh, causal,
                                                   window, dtype):
    arrays = _attn_inputs(b, h, kh, s, dh)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in arrays)
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == td and got.shape == (b, h, s, dh)
    got = got.float().numpy()
    pallas = flash_attention(jq, jk, jv, causal=causal, window=window,
                             block_q=64, block_k=64, interpret=True)
    oracle = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_attention_ragged_lengths_and_empty_rows():
    """Sq != Sk and lengths off any tile; a window of 1 under a non-causal
    mask leaves rows whose keys all lie outside it, which come out 0."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 37, 16), np.float32)
    k = rng.standard_normal((1, 2, 53, 16), np.float32)
    v = rng.standard_normal((1, 2, 53, 16), np.float32)
    for causal, window in ((True, None), (False, None), (True, 5)):
        got = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=causal, window=window).numpy()
        want = jref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                  causal=causal, window=window)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    qf = torch.from_numpy(rng.standard_normal((1, 2, 8, 16), np.float32))
    kf = torch.from_numpy(rng.standard_normal((1, 2, 4, 16), np.float32))
    got = ops.attention(qf, kf, kf, causal=False, window=1)
    # Row q sees keys k > q - 1, i.e. k >= q: rows 4..7 see none.
    assert torch.equal(got[:, :, 4:], torch.zeros_like(got[:, :, 4:]))
    assert got[:, :, :4].abs().sum() > 0


def _ssd_inputs(b, s, h, p, n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1).astype(
        np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    d = np.full((h,), 0.5, np.float32)
    return x, dt, a, bm, cm, d


SSD_SHAPES = [(1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 64),
              (1, 128, 1, 8, 4, 32), (2, 128, 3, 64, 64, 64)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_plain_matches_pallas_and_oracles(b, s, h, p, n, chunk):
    arrays = _ssd_inputs(b, s, h, p, n)
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    y_pallas = np.asarray(pallas_ssd(*j, chunk=chunk, interpret=True))
    y_seq, h_seq = (np.asarray(v) for v in jref.ssd_ref(*j,
                                                        return_state=True))
    y_chk, h_chk = (np.asarray(v) for v in jref.ssd_chunked_ref(
        *j, chunk=chunk, return_state=True))
    for fn in (ref.ssd_chunked_ref, ref.ssd_padded_ref):
        y, st = fn(*t, chunk=chunk, return_state=True)
        y_only = fn(*t, chunk=chunk)
        assert torch.equal(y, y_only)
        for want in (y_pallas, y_seq, y_chk):
            np.testing.assert_allclose(y.numpy(), want, rtol=2e-4, atol=2e-4)
        for want in (h_seq, h_chk):
            np.testing.assert_allclose(st.numpy(), want, rtol=2e-4,
                                       atol=2e-4)
    y, st = ref.ssd_ref(*t, return_state=True)
    np.testing.assert_allclose(y.numpy(), y_seq, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.numpy(), h_seq, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s,chunk", [(100, 32), (40, 40), (17, 64)])
def test_ssd_padded_and_short(s, chunk):
    """A length off the chunk grid (padded with zero rows, which leave the
    state unchanged) and S < chunk, against the sequential oracle."""
    arrays = _ssd_inputs(2, s, 3, 16, 8, seed=s)
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    y_seq, h_seq = (np.asarray(v) for v in jref.ssd_ref(*j,
                                                        return_state=True))
    y, st = ref.ssd_padded_ref(*t, chunk=chunk, return_state=True)
    assert y.shape == (2, s, 3, 16)
    np.testing.assert_allclose(y.numpy(), y_seq, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.numpy(), h_seq, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s,chunk", [(128, 64), (64, 64), (100, 64),
                                     (17, 17)])
@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_wrapper_on_cpu_takes_the_references_choice(s, chunk,
                                                        return_state):
    arrays = _ssd_inputs(1, s, 2, 16, 8, seed=7)
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    got = ops.ssd(*t, chunk=chunk, return_state=return_state)
    want = jops.ssd(*j, chunk=chunk, return_state=return_state)
    got, want = (got, want) if return_state else ((got,), (want,))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


def test_ssd_strong_decay_stays_finite():
    """With a chunk's cumulated decay beyond e^88 (zamba2's a reaches -80),
    the reference's chunked jnp form (its prefill path off the TPU) takes
    exp of the unmasked upper triangle and returns NaN; the port masks
    first and matches the sequential scan, which stays finite."""
    x, dt, a, bm, cm, d = _ssd_inputs(1, 128, 4, 16, 8, seed=5)
    a = np.array([-1.0, -20.0, -50.0, -80.0], np.float32)
    dt = dt * 10.0
    j = [jnp.asarray(v) for v in (x, dt, a, bm, cm, d)]
    t = [torch.from_numpy(v) for v in (x, dt, a, bm, cm, d)]
    assert np.isnan(np.asarray(jref.ssd_chunked_ref(*j, chunk=64))).any()
    y_seq, h_seq = (np.asarray(v) for v in jref.ssd_ref(*j,
                                                        return_state=True))
    assert np.isfinite(y_seq).all()
    for y, st in (ref.ssd_chunked_ref(*t, chunk=64, return_state=True),
                  ops.ssd(*t, chunk=64, return_state=True)):
        np.testing.assert_allclose(y.numpy(), y_seq, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(st.numpy(), h_seq, rtol=2e-4, atol=2e-4)


def test_wrappers_refuse_other_devices():
    """Only CPU tensors reach the plain versions; anything else that is not
    one CUDA device raises instead of moving."""
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        ops.attention(q, q.to("meta"), q)
    x = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        ops.ssd(x, torch.zeros(1, 4, 2).to("meta"), torch.zeros(2),
                torch.zeros(1, 4, 3), torch.zeros(1, 4, 3), torch.zeros(2))
    assert jax.default_backend() == "cpu"


# ---------------------------------------------------------------------------
# The card kernels' precision schemes, emulated in plain PyTorch on the CPU:
# K6 runs its f32 products on the tensor cores as three TF32 products
# (3xTF32), K5 rounds its probabilities to bf16 before p.v.

def _tf32(t):
    """What the tensor core reads of an f32 operand as TF32: the value with
    its low 13 mantissa bits masked off (rounded toward zero)."""
    bits = t.contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def _tf32_nearest(t):
    """f32 rounded to TF32 as the K6 kernel splits it: half an ulp added to
    the 13 dropped bits, then masked (nearest, ties away from zero)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the K6 kernel runs it: each f32 operand split into hi (TF32,
    nearest) and lo = v - hi, which the tensor core reads as TF32 in turn
    (truncated); lo*hi + hi*lo + hi*hi summed."""
    ah, bh = _tf32_nearest(a), _tf32_nearest(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _ssd_emulated(x, dt, a, b, c, d, chunk, mm):
    """The K6 kernel's chunk loop with its products through ``mm``: per
    chunk G = C B^T, then per head W = G o exp(s_i - s_j) o dt_j (masked
    before the exponential), y = W x + exp(s) o (C h) + d x and
    h = exp(s_last) h + (B o u)^T x."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    pad = -s % chunk
    if pad:
        x, dt, b, c = (torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, b, c))
    tril = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    state = torch.zeros((bsz, h, n, p))
    ys = []
    for t0 in range(0, s + pad, chunk):
        xs = x[:, t0:t0 + chunk].permute(0, 2, 1, 3)          # (B,H,Q,P)
        dts = dt[:, t0:t0 + chunk].permute(0, 2, 1)           # (B,H,Q)
        bs, cs = b[:, t0:t0 + chunk], c[:, t0:t0 + chunk]     # (B,Q,N)
        sc = torch.cumsum(dts * a[None, :, None], dim=-1)
        g = mm(cs, bs.transpose(1, 2))                        # (B,Q,Q)
        seg = torch.where(tril, sc[..., :, None] - sc[..., None, :],
                          torch.tensor(float("-inf")))
        w = g[:, None] * torch.exp(seg) * dts[..., None, :]
        y = (mm(w, xs) + torch.exp(sc)[..., None] * mm(cs[:, None], state)
             + d[None, :, None, None] * xs)
        ys.append(y.permute(0, 2, 1, 3))
        u = torch.exp(sc[..., -1:] - sc) * dts
        state = (torch.exp(sc[..., -1])[..., None, None] * state
                 + mm((bs[:, None] * u[..., None]).transpose(2, 3), xs))
    return torch.cat(ys, dim=1)[:, :s], state


def test_ssd_3xtf32_products_meet_the_tolerance():
    """At zamba2's head and state widths, the kernel's split products stay
    within 2e-4 of the plain version; one TF32 rounding of each operand
    would not."""
    t = [torch.from_numpy(v) for v in _ssd_inputs(1, 128, 8, 64, 64, seed=11)]
    want_y, want_h = ref.ssd_padded_ref(*t, chunk=64, return_state=True)
    y, st = _ssd_emulated(*t, 64, _mm_3xtf32)
    err = max(float((y - want_y).abs().max()), float((st - want_h).abs().max()))
    assert err <= 2e-4
    y1, st1 = _ssd_emulated(*t, 64, _mm_tf32)
    err1 = max(float((y1 - want_y).abs().max()),
               float((st1 - want_h).abs().max()))
    assert err1 > 2e-4 > 10 * err


def _attention_bf16_p(q, k, v, *, causal, window, split, block_k=64):
    """The K5 kernel's bf16 scheme: f32 logits from bf16 q and k, an online
    softmax over tiles of ``block_k`` keys with f32 m and l, probabilities
    as bf16 before p.v (with ``split``, as hi + lo, two bf16 terms, as the
    kernel does; else one rounding), f32 accumulators, the output rounded
    to bf16."""
    b, h, sq, dh = q.shape
    kh, sk = k.shape[1], k.shape[2]
    rep = torch.arange(h) // (h // kh)
    qf, kf, vf = q.float(), k.float()[:, rep], v.float()[:, rep]
    s = qf @ kf.transpose(2, 3) * dh ** -0.5
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    m = torch.full((b, h, sq, 1), ref.NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, dh))
    for k0 in range(0, sk, block_k):
        mk = mask[:, k0:k0 + block_k]
        st = torch.where(mk, s[..., k0:k0 + block_k],
                         torch.tensor(ref.NEG_INF))
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mk, torch.exp(st - m_new), torch.zeros(()))
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        vt = vf[:, :, k0:k0 + block_k]
        pv = hi @ vt
        if split:
            pv = (p - hi).bfloat16().float() @ vt + pv
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.where(l == 0, torch.ones(()), l)).bfloat16()


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("b,h,kh,s,dh,window", [(2, 8, 2, 256, 80, None),
                                                (1, 2, 1, 1024, 256, 512)])
def test_attention_bf16_probabilities_meet_the_tolerance(b, h, kh, s, dh,
                                                         window, split):
    """Probabilities rounded to bf16 before p.v stay within the bf16
    tolerance 2e-2 of the plain version; split into two bf16 terms, as the
    tensor-core kernel keeps them, they are closer still."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _attn_inputs(b, h, kh, s, dh, seed=5))
    want = ref.attention_ref(q, k, v, causal=True, window=window).float()
    got = _attention_bf16_p(q, k, v, causal=True, window=window,
                            split=split)
    assert got.dtype == torch.bfloat16
    err = float((got.float() - want).abs().max())
    assert err <= 2e-2
    if split:
        one = _attention_bf16_p(q, k, v, causal=True, window=window,
                                split=False)
        assert err <= float((one.float() - want).abs().max())
