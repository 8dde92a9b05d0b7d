"""Mamba-2 block (SSD): full-sequence pass (prefill) through the SSD kernel
(K6), and stateful one-token decode in plain PyTorch.

Structure as the reference's (arXiv:2405.21060, ngroups = 1): in_proj ->
(z | x | B | C | dt), short causal depthwise conv over (x, B, C), softplus
dt, SSD core, gated RMSNorm, out_proj. Decode carries (conv window, SSM
state).

On a mesh the mixer runs whole on every rank (its packed ``in_proj`` is
gathered over the model axis: ``models/parallel.py``); a decode state
split along its state dim is stepped on the rank's slice of B and C and
its ``C h`` summed over the model axis."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .common import ModelConfig, current_plan, init_dense, pshard, rms_norm


def _dims(cfg: ModelConfig):
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_in = h * p
    conv_dim = d_in + 2 * n
    return h, p, n, d_in, conv_dim


def init_mamba_layer(cfg: ModelConfig, gen: torch.Generator) -> dict:
    h, _, n, d_in, conv_dim = _dims(cfg)
    d = cfg.d_model
    dev = gen.device
    return {
        "in_proj": init_dense(gen, (d, 2 * d_in + 2 * n + h), dtype=cfg.dtype),
        "conv_w": (torch.randn((cfg.conv_width, conv_dim), generator=gen,
                               device=dev) * 0.1).to(cfg.dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=cfg.dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, float(h), h, device=dev)),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "norm": torch.zeros((d_in,), dtype=cfg.dtype, device=dev),
        "out_proj": init_dense(gen, (d_in, d), dtype=cfg.dtype),
    }


def _split_proj(cfg, proj):
    _, _, n, d_in, _ = _dims(cfg)
    h = cfg.ssm_heads
    return torch.split(proj, [d_in, d_in, n, n, h], dim=-1)


def mamba_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
               return_state: bool = False, seq: bool = False):
    """x (B, S, D) -> (B, S, D); with ``return_state`` also the decode state
    {"conv": (B, K-1, conv) f32, "ssm": (B, H, N, P) f32} after the last
    position, the SSD kernel's final state. ``seq``: the residual stream
    is split along the sequence (``models.common.pshard``)."""
    h, p_, n, d_in, _ = _dims(cfg)
    x = pshard(x, "in", seq)
    b, s, _ = x.shape
    cd = cfg.compute_dtype

    proj = x @ p["in_proj"].to(cd)
    z, xs, bmat, cmat, dt = _split_proj(cfg, proj)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)                # (B,S,conv)

    # Causal depthwise conv of width K: the ordered sum of K shifted slices
    # in the compute dtype, as the reference sums them.
    k = cfg.conv_width
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    w = p["conv_w"].to(cd)
    conv = pad[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        conv = conv + pad[:, i:i + s, :] * w[i][None, None, :]
    conv = F.silu(conv + p["conv_b"].to(cd))
    xs, bmat, cmat = torch.split(conv, [d_in, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    out = kops.ssd(
        xs.reshape(b, s, h, p_).float().contiguous(), dt.contiguous(), a,
        bmat.float().contiguous(), cmat.float().contiguous(), p["d_skip"],
        chunk=min(64, s), return_state=return_state)
    y, final_ssm = out if return_state else (out, None)
    y = y.reshape(b, s, d_in).to(cd)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = pshard(y @ p["out_proj"].to(cd), "whole", seq)
    if not return_state:
        return out
    conv_state = pad[:, s:s + k - 1, :].float()              # last K-1 raw
    return out, {"conv": conv_state, "ssm": final_ssm}


def mamba_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """x (B, 1, D) against (conv (B, K-1, conv), ssm (B, H, N, P)). Returns
    (y (B, 1, D), new conv state, new ssm state)."""
    h, p_, n, d_in, _ = _dims(cfg)
    b = x.shape[0]
    cd = cfg.compute_dtype

    proj = x[:, 0] @ p["in_proj"].to(cd)
    z, xs, bmat, cmat, dt = _split_proj(cfg, proj)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)                # (B, conv)

    window = torch.cat([conv_state, xbc[:, None, :].to(conv_state.dtype)],
                       dim=1)                                # (B, K, conv)
    conv = torch.einsum("bkc,kc->bc", window.to(cd), p["conv_w"].to(cd))
    conv = F.silu(conv + p["conv_b"].to(cd))
    xs, bmat, cmat = torch.split(conv, [d_in, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])               # (B, H)
    a = -torch.exp(p["a_log"])                               # (H,)
    decay = torch.exp(dt * a[None, :])
    xh = xs.reshape(b, h, p_).float()
    n_local = ssm_state.shape[2]
    if n_local != n:                     # the state split over the model axis
        plan = current_plan()
        bmat, cmat = plan.ssm_slice(bmat, n_local), plan.ssm_slice(cmat,
                                                                   n_local)
    upd = torch.einsum("bn,bhp->bhnp", bmat.float(), xh * dt[..., None])
    ssm = decay[..., None, None] * ssm_state + upd
    y = torch.einsum("bn,bhnp->bhp", cmat.float(), ssm)
    if n_local != n:
        y = plan.model_sum(y)
    y = y + p["d_skip"][None, :, None] * xh
    y = y.reshape(b, d_in).to(cd)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["out_proj"].to(cd))[:, None, :]
    return out, window[:, 1:, :].to(conv_state.dtype), ssm
