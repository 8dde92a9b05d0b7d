"""Whisper-style encoder-decoder backbone.

The conv/mel audio frontend is a stub, as in the reference: the encoder
takes precomputed frame embeddings (B, S_enc, D). The encoder is
bidirectional attention (the attention kernel with ``causal=False``; RoPE
as in the reference) + MLP; the decoder adds causal self-attention and
cross-attention to the encoder output, the latter in plain f32 softmax
attention without rotation. The decode cache holds the self-attention K/V
per layer and the cross-attention K/V, computed once from the encoder
output. Prefill encodes, then steps ``decode_step`` over the prompt, as
the reference does."""

from __future__ import annotations

import torch

from .attention import attn_decode, attn_full, init_attn_layer, out_boundary
from .common import (ModelConfig, cross_entropy, current_plan, init_dense,
                     layer_params, layer_stack, local_params, pshard,
                     rms_norm, stack_layers)
from .transformer import (_embed, _logits, _remat, _zeros, init_mlp_layer,
                          mlp, seq_split, split_layers)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random weights drawn from ``gen`` on its device, in the reference's
    distributions and layout (the values differ: another generator)."""
    d = cfg.d_model

    def zeros():
        return _zeros(cfg, gen, d)

    def enc_block():
        return {"norm1": zeros(), "attn": init_attn_layer(cfg, gen),
                "norm2": zeros(), "mlp": init_mlp_layer(cfg, gen)}

    def dec_block():
        return {"norm1": zeros(), "self_attn": init_attn_layer(cfg, gen),
                "norm_x": zeros(), "cross_attn": init_attn_layer(cfg, gen),
                "norm2": zeros(), "mlp": init_mlp_layer(cfg, gen)}

    encoder = stack_layers(cfg.encoder_layers, enc_block, "encoder")
    decoder = stack_layers(cfg.n_layers, dec_block, "decoder")
    return local_params({
        "embed": init_dense(gen, (cfg.vocab, d), dtype=cfg.dtype),
        "head": init_dense(gen, (d, cfg.vocab), dtype=cfg.dtype),
        "enc_norm": zeros(),
        "final_norm": zeros(),
        "encoder": encoder,
        "decoder": decoder,
    })


def _enc_block(cfg, p, x):
    p = layer_params(p, ("encoder",))
    h, _ = attn_full(cfg, p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps),
                     window=0, causal=False)
    x = x + h
    return (x + mlp(cfg, p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps)),)


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """frames (B, S_enc, D) from the stub frontend -> encoder states."""
    remat = remat and torch.is_grad_enabled()
    x = frames.to(cfg.compute_dtype)   # never split along the sequence
    for p in split_layers(layer_stack(params["encoder"], "encoder"),
                          cfg.encoder_layers):
        x = _remat(_enc_block, cfg, p, x) if remat else \
            _enc_block(cfg, p, x)[0]
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_attend(cfg, p, x, enc_k, enc_v, seq=False):
    """Cross attention with precomputed encoder K/V (no rotation)."""
    x = pshard(x, "in", seq)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    cd = cfg.compute_dtype
    q = (x @ p["wq"].to(cd)).reshape(b, s, -1, hd)
    group = q.shape[2] // enc_k.shape[2]
    qh = q.transpose(1, 2).float()
    kh = enc_k.transpose(1, 2).float().repeat_interleave(group, dim=1)
    vh = enc_v.transpose(1, 2).float().repeat_interleave(group, dim=1)
    a = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qh, kh) * (hd ** -0.5),
                      dim=-1)
    y = torch.einsum("bhqk,bhkd->bhqd", a, vh).transpose(1, 2).reshape(b, s,
                                                                       -1)
    return pshard(y.to(cd) @ p["wo"].to(cd), out_boundary(cfg, p["wo"]),
                  seq)


def _enc_kv(cfg, p, enc):
    b, s, _ = enc.shape
    hd = cfg.resolved_head_dim
    cd = cfg.compute_dtype
    k = (enc @ p["wk"].to(cd)).reshape(b, s, -1, hd)
    v = (enc @ p["wv"].to(cd)).reshape(b, s, -1, hd)
    return k, v


def _dec_block(cfg, p, x, enc, seq=False):
    p = layer_params(p, ("decoder",))
    h, _ = attn_full(cfg, p["self_attn"],
                     rms_norm(x, p["norm1"], cfg.norm_eps), window=0,
                     seq=seq)
    x = x + h
    ek, ev = _enc_kv(cfg, p["cross_attn"], enc)
    x = x + _cross_attend(cfg, p["cross_attn"],
                          rms_norm(x, p["norm_x"], cfg.norm_eps), ek, ev,
                          seq)
    return (x + mlp(cfg, p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                    seq),)


def decode_full(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                enc: torch.Tensor, *, remat: bool = False) -> torch.Tensor:
    """Teacher-forced decoder pass -> logits (B, S_dec, V)."""
    remat = remat and torch.is_grad_enabled()
    seq = seq_split(tokens)
    x = _embed(cfg, params, tokens, seq)
    for p in split_layers(layer_stack(params["decoder"], "decoder"),
                          cfg.n_layers):
        x = _remat(_dec_block, cfg, p, x, enc, seq) if remat else \
            _dec_block(cfg, p, x, enc, seq)[0]
    return _logits(cfg, params, x, seq)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Mean token cross-entropy of ``batch`` ({"frames", "tokens",
    "targets", optional "mask"} tensors on the params' device). Each
    encoder and decoder layer is recomputed in the backward pass when
    ``cfg.remat``."""
    enc = encode(cfg, params, batch["frames"], remat=cfg.remat)
    logits = decode_full(cfg, params, batch["tokens"], enc, remat=cfg.remat)
    plan = current_plan()
    if plan is not None:
        return plan.loss(logits, batch["targets"], batch.get("mask"), None,
                         0.0)
    return cross_entropy(logits, batch["targets"], batch.get("mask"))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed decode cache: self-attention ``k``/``v`` (L, B, max_len, KH,
    Dh), cross-attention ``ek``/``ev`` (L, B, enc_len, KH, Dh), all in
    ``dtype``; ``pos`` a Python int."""
    hd = cfg.resolved_head_dim
    plan = current_plan()

    def z(s):
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, hd)
        if plan is not None:
            shape = plan.cache_local_shape(shape)
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"k": z(max_len), "v": z(max_len), "ek": z(enc_len),
            "ev": z(enc_len), "pos": 0}


def prefill(cfg: ModelConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor, max_len: int):
    """Encode, compute the cross K/V once per layer, then step the prompt
    through ``decode_step``: (last-position logits (B, 1, V), cache)."""
    enc = encode(cfg, params, frames)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, enc.shape[1],
                       dtype=cfg.compute_dtype, device=tokens.device)
    decoder = layer_stack(params["decoder"], "decoder")
    for i, p in enumerate(split_layers(decoder, cfg.n_layers)):
        p = layer_params(p, ("decoder",))
        ek, ev = _enc_kv(cfg, p["cross_attn"], enc)
        cache["ek"][i] = ek
        cache["ev"][i] = ev
    logits = None
    for i in range(s):
        logits, cache = decode_step(cfg, params, cache, tokens[:, i:i + 1])
    return logits, cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache). The
    self-attention cache is written in place; ``pos`` advances by one."""
    cd = cfg.compute_dtype
    x = _embed(cfg, params, tokens)
    pos = cache["pos"]
    decoder = layer_stack(params["decoder"], "decoder")
    for i, p in enumerate(split_layers(decoder, cfg.n_layers)):
        p = layer_params(p, ("decoder",))
        x = x + attn_decode(cfg, p["self_attn"],
                            rms_norm(x, p["norm1"], cfg.norm_eps),
                            cache["k"][i], cache["v"][i], pos, window=0)
        x = x + _cross_attend(cfg, p["cross_attn"],
                              rms_norm(x, p["norm_x"], cfg.norm_eps),
                              cache["ek"][i].to(cd), cache["ev"][i].to(cd))
        x = x + mlp(cfg, p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps))
    cache["pos"] = pos + 1
    return _logits(cfg, params, x), cache
