"""GQA attention with RoPE: the full-sequence path (prefill) through the
attention kernel (K5), and one-token decode against a KV cache in plain
PyTorch, as the reference decodes (a (1, S) contraction per head).

The layer loop of the port is plain Python, so every layer's window is a
Python int (0 = full attention) and every full-sequence layer runs K5.

The head counts come from the weights' shapes: on a mesh that splits the
heads over the model axis, each rank projects, caches and attends its own
query and kv heads, and its ``wo`` product is a partial sum that the
sharding hook sums over that axis (``pshard(..., "partial")``)."""

from __future__ import annotations

import torch

from ..kernels import ops as kops
from .common import ModelConfig, init_dense, pshard, rope

FULL_WINDOW = 1 << 30  # "no window" as a mask width


def init_attn_layer(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": init_dense(gen, (d, cfg.n_heads * hd), dtype=cfg.dtype),
        "wk": init_dense(gen, (d, cfg.n_kv_heads * hd), dtype=cfg.dtype),
        "wv": init_dense(gen, (d, cfg.n_kv_heads * hd), dtype=cfg.dtype),
        "wo": init_dense(gen, (cfg.n_heads * hd, d), dtype=cfg.dtype),
    }


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    cd = cfg.compute_dtype
    q = (x @ p["wq"].to(cd)).reshape(b, s, -1, hd)
    k = (x @ p["wk"].to(cd)).reshape(b, s, -1, hd)
    v = (x @ p["wv"].to(cd)).reshape(b, s, -1, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_boundary(cfg: ModelConfig, wo: torch.Tensor) -> str:
    """The hook's mark after the ``wo`` product: "partial" when this rank
    holds only some of the heads."""
    return ("partial" if wo.shape[0] != cfg.n_heads * cfg.resolved_head_dim
            else "whole")


def attn_full(cfg: ModelConfig, p: dict, x: torch.Tensor, *, window: int,
              causal: bool = True, seq: bool = False) -> tuple:
    """Full-sequence attention, x (B, S, D); ``window`` 0 = full. Returns
    (y (B, S, D), (k, v) each (B, S, KH, Dh)). ``seq``: the residual
    stream is split along the sequence (``models.common.pshard``)."""
    x = pshard(x, "in", seq)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = _project_qkv(cfg, p, x, positions)
    y = kops.attention(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=causal,
                       window=window or None)
    y = y.transpose(1, 2).reshape(b, s, -1).to(cfg.compute_dtype)
    return pshard(y @ p["wo"].to(cfg.compute_dtype),
                  out_boundary(cfg, p["wo"]), seq), (k, v)


def attn_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int, *,
                window: int = 0) -> torch.Tensor:
    """One-token decode: x (B, 1, D); cache_k/v (B, S_max, KH, Dh) are
    written at ``pos`` in place (the reference's dynamic_update_slice).
    Returns y (B, 1, D)."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    cache_k[:, pos:pos + 1] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v.to(cache_v.dtype)

    s_max, kv_heads = cache_k.shape[1], cache_k.shape[2]
    group = q.shape[2] // kv_heads
    w = window if window > 0 else FULL_WINDOW
    kp = torch.arange(s_max, device=x.device)
    valid = (kp <= pos) & (kp > pos - w)
    # Fold GQA: q heads as (KH, group) against the cache, no repeated KV.
    qg = q[:, 0].float().reshape(b, kv_heads, group, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.float()) * (hd ** -0.5)
    logits = torch.where(valid[None, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    y = torch.einsum("bkgs,bskd->bkgd", probs, cache_v.float())
    y = y.reshape(b, 1, -1).to(cfg.compute_dtype)
    return pshard(y @ p["wo"].to(cfg.compute_dtype),
                  out_boundary(cfg, p["wo"]))
