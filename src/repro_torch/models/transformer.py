"""Decoder-only LM assembly for the dense / VLM / MoE / SSM / hybrid
families.

Parameters keep the reference's layout: stacked ``(L, ...)`` layer leaves,
split into per-layer views once per forward (``torch.unbind``, so training
gives each stacked leaf one gradient stack) and run by a plain Python
loop. Each layer's attention window is a Python int, so every
full-sequence attention layer goes through the attention kernel. The
zamba2-style hybrid runs ``attn_every`` mamba layers, then the one shared
attention+MLP block, per site, with a KV cache per site. An MoE block is
a dense block whose MLP is ``moe.moe_ffn``; the full-sequence forward sums
its load-balancing aux losses over the layers.

``loss_fn`` is the training loss. With ``cfg.remat`` it recomputes every
layer (each mamba layer, each shared-block site) in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does.
The encoder-decoder family is ``encdec.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .attention import attn_decode, attn_full, init_attn_layer
from .common import (ModelConfig, cross_entropy, current_plan, init_dense,
                     layer_params, local_params, pshard, rms_norm,
                     stack_layers)
from .mamba2 import init_mamba_layer, mamba_decode, mamba_full
from .moe import init_moe_layer, moe_ffn

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
#: The families whose every layer is an attention block.
ATTN_FAMILIES = ("dense", "vlm", "moe")
AUX_LOSS_COEF = 0.01


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: the {cfg.family} family is not "
                         f"decoder-only (encdec is models/encdec.py)")


# ------------------------------------------------------------------- init
def init_mlp_layer(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": init_dense(gen, (d, f), dtype=cfg.dtype),
        "w3": init_dense(gen, (d, f), dtype=cfg.dtype),
        "w2": init_dense(gen, (f, d), dtype=cfg.dtype),
    }


def _zeros(cfg: ModelConfig, gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=cfg.dtype, device=gen.device)


def _init_block(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d = cfg.d_model
    if cfg.family not in ATTN_FAMILIES:
        return {"norm1": _zeros(cfg, gen, d),
                "mamba": init_mamba_layer(cfg, gen)}
    block = {"norm1": _zeros(cfg, gen, d), "attn": init_attn_layer(cfg, gen),
             "norm2": _zeros(cfg, gen, d)}
    if cfg.family == "moe":
        block["moe"] = init_moe_layer(cfg, gen)
    else:
        block["mlp"] = init_mlp_layer(cfg, gen)
    return block


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random weights drawn from ``gen`` on its device, in the reference's
    distributions and layout (the values differ: another generator). Each
    stacked layer leaf is allocated once and filled layer by layer."""
    check_family(cfg)
    params = {
        "embed": init_dense(gen, (cfg.vocab, cfg.d_model), dtype=cfg.dtype),
        "final_norm": _zeros(cfg, gen, cfg.d_model),
        "layers": stack_layers(cfg.n_layers, lambda: _init_block(cfg, gen),
                               "layers"),
    }
    if not cfg.tie_embeddings:
        params["head"] = init_dense(gen, (cfg.d_model, cfg.vocab),
                                    dtype=cfg.dtype)
    if cfg.family == "hybrid":
        params["shared"] = {
            "norm1": _zeros(cfg, gen, cfg.d_model),
            "attn": init_attn_layer(cfg, gen),
            "norm2": _zeros(cfg, gen, cfg.d_model),
            "mlp": init_mlp_layer(cfg, gen),
        }
    return local_params(params)


# ---------------------------------------------------------------- helpers
def split_layers(params: dict, n: int) -> list[dict]:
    """The ``n`` layers' parameters, views made by one ``torch.unbind`` per
    stacked leaf. Indexing each leaf per layer gives the same views, but in
    training each index's backward fills a zero gradient of the whole
    stacked leaf and adds it: ``n`` of them per leaf. Unbinding stacks the
    ``n`` layer gradients once."""
    out = [{} for _ in range(n)]
    for k, v in params.items():
        parts = split_layers(v, n) if isinstance(v, dict) else v.unbind(0)
        for d, part in zip(out, parts):
            d[k] = part
    return out


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor,
        seq: bool = False) -> torch.Tensor:
    cd = cfg.compute_dtype
    x = pshard(x, "in", seq)
    h = F.silu(x @ p["w1"].to(cd)) * (x @ p["w3"].to(cd))
    return pshard(h @ p["w2"].to(cd),
                  "partial" if p["w2"].shape[0] != cfg.d_ff else "whole",
                  seq)


def window_schedule(cfg: ModelConfig) -> list[int]:
    """Per-layer attention window (0 = full), gemma3's 5:1 local:global."""
    if cfg.sliding_window and cfg.global_every:
        return [0 if (i + 1) % cfg.global_every == 0 else cfg.sliding_window
                for i in range(cfg.n_layers)]
    return [cfg.sliding_window] * cfg.n_layers


def seq_split(tokens: torch.Tensor) -> bool:
    """Whether a full pass over ``tokens`` (B, S) runs with the residual
    stream split along the sequence: under an installed plan whose policy
    shards the sequence, where the model axis divides S."""
    plan = current_plan()
    return plan is not None and plan.seq_split(tokens.shape[1])


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           seq: bool = False):
    plan = current_plan()
    if plan is not None:
        return plan.embed(cfg, params, tokens, seq)
    x = params["embed"][tokens].to(cfg.compute_dtype)
    return x * (cfg.d_model ** 0.5)


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor,
            seq: bool = False):
    plan = current_plan()
    if plan is not None:
        return plan.logits(cfg, params, x, seq)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head.to(cfg.compute_dtype)


def _ffn(cfg, p, z, seq=False):
    """The block's MLP or MoE FFN: (y, the MoE aux loss or None)."""
    if "moe" in p:
        return moe_ffn(cfg, p["moe"], z, seq)
    return mlp(cfg, p["mlp"], z, seq), None


def _attn_block(cfg, p, x, window, seq=False):
    """A dense, VLM or MoE block: (x, aux or None, (k, v))."""
    p = layer_params(p, ("layers",))
    h, kv = attn_full(cfg, p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps),
                      window=window, seq=seq)
    x = x + h
    y, aux = _ffn(cfg, p, rms_norm(x, p["norm2"], cfg.norm_eps), seq)
    return x + y, aux, kv


def _mamba_block(cfg, p, x, seq=False, return_state=False):
    p = layer_params(p, ("layers",))
    h = mamba_full(cfg, p["mamba"], rms_norm(x, p["norm1"], cfg.norm_eps),
                   return_state=return_state, seq=seq)
    if return_state:
        return x + h[0], h[1]
    return x + h, None


def _shared_block(cfg, shared, x, seq=False):
    shared = layer_params(shared, ("shared",))
    h, kv = attn_full(cfg, shared["attn"],
                      rms_norm(x, shared["norm1"], cfg.norm_eps), window=0,
                      seq=seq)
    x = x + h
    x = x + mlp(cfg, shared["mlp"],
                rms_norm(x, shared["norm2"], cfg.norm_eps), seq)
    return x, kv


def _remat(block, cfg, *args, n_out: int = 1):
    """``block(cfg, *args)``'s first output (its first ``n_out`` when more
    than one) with its activations recomputed in the backward pass instead
    of kept (the forward draws no random numbers, so no RNG state is
    stashed)."""

    def run(*a):
        out = block(cfg, *a)
        return out[0] if n_out == 1 else out[:n_out]

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


# ------------------------------------------------------------ full forward
def forward_full(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                 collect_cache: bool = False, remat: bool = False):
    """Full-sequence forward: (hidden (B, S, D), split along the sequence
    where :func:`seq_split` says, the MoE aux loss summed
    over the layers (a 0-d f32 tensor, zero for the other families),
    caches or None).

    caches: dense/vlm/moe ``(k, v)`` stacked (L, B, S, KH, Dh); ssm
    ``{"conv", "ssm"}`` stacked (L, ...); hybrid ``(k, v, states)`` with k/v
    stacked per site (n_sites, ...) and the mamba states per layer. With
    ``remat`` (and autograd recording) each layer is recomputed in the
    backward pass; it cannot collect caches."""
    check_family(cfg)
    remat = remat and torch.is_grad_enabled()
    if remat and collect_cache:
        raise ValueError("remat recomputes layers and collects no cache")
    seq = seq_split(tokens)
    x = _embed(cfg, params, tokens, seq)
    layers = split_layers(params["layers"], cfg.n_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.family in ATTN_FAMILIES:
        ks, vs = [], []
        for p, w in zip(layers, window_schedule(cfg)):
            if remat:
                x, a = _remat(_attn_block, cfg, p, x, w, seq, n_out=2)
            else:
                x, a, (k, v) = _attn_block(cfg, p, x, w, seq)
                if collect_cache:
                    ks.append(k)
                    vs.append(v)
            if a is not None:
                aux = aux + a
        return x, aux, ((torch.stack(ks), torch.stack(vs)) if collect_cache
                        else None)

    convs, ssms, ks, vs = [], [], [], []
    for i, p in enumerate(layers):
        if remat:
            x = _remat(_mamba_block, cfg, p, x, seq)
        else:
            x, st = _mamba_block(cfg, p, x, seq, collect_cache)
            if collect_cache:
                convs.append(st["conv"])
                ssms.append(st["ssm"])
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            if remat:
                x = _remat(_shared_block, cfg, params["shared"], x, seq)
                continue
            x, (k, v) = _shared_block(cfg, params["shared"], x, seq)
            if collect_cache:
                ks.append(k)
                vs.append(v)
    if not collect_cache:
        return x, aux, None
    states = {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}
    if cfg.family == "ssm":
        return x, aux, states
    return x, aux, (torch.stack(ks), torch.stack(vs), states)


# ------------------------------------------------------------------- loss
def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "targets",
    optional "mask"} tensors on the params' device) plus ``AUX_LOSS_COEF``
    times the MoE load-balancing loss (zero for the other families). The
    layers are recomputed in the backward pass when ``cfg.remat``."""
    x, aux, _ = forward_full(cfg, params, batch["tokens"], remat=cfg.remat)
    plan = current_plan()
    if plan is not None:
        logits = _logits(cfg, params, x, seq_split(batch["tokens"]))
        return plan.loss(logits, batch["targets"],
                         batch.get("mask"), aux, AUX_LOSS_COEF)
    ce = cross_entropy(_logits(cfg, params, x), batch["targets"],
                       batch.get("mask"))
    return ce + AUX_LOSS_COEF * aux


# ------------------------------------------------------------------ decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed decode cache: KV in ``dtype``, conv and ssm states in f32,
    ``pos`` a Python int."""
    check_family(cfg)
    hd = cfg.resolved_head_dim
    plan = current_plan()

    def z(*shape, dt=torch.float32):
        if plan is not None:
            shape = plan.cache_local_shape(shape)
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.family in ATTN_FAMILIES:
        kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
        return {"k": z(*kv, dt=dtype), "v": z(*kv, dt=dtype), "pos": 0}
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = h * p + 2 * n
    cache = {"conv": z(cfg.n_layers, batch, cfg.conv_width - 1, conv_dim),
             "ssm": z(cfg.n_layers, batch, h, n, p), "pos": 0}
    if cfg.family == "hybrid":
        kv = (cfg.n_layers // cfg.attn_every, batch, max_len,
              cfg.n_kv_heads, hd)
        cache["k"] = z(*kv, dt=dtype)
        cache["v"] = z(*kv, dt=dtype)
    return cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache). The
    cache's tensors are updated in place; ``pos`` advances by one."""
    check_family(cfg)
    x = _embed(cfg, params, tokens)
    pos = cache["pos"]
    layers = split_layers(params["layers"], cfg.n_layers)

    if cfg.family in ATTN_FAMILIES:
        for i, (p, w) in enumerate(zip(layers, window_schedule(cfg))):
            p = layer_params(p, ("layers",))
            x = x + attn_decode(cfg, p["attn"],
                                rms_norm(x, p["norm1"], cfg.norm_eps),
                                cache["k"][i], cache["v"][i], pos, window=w)
            x = x + _ffn(cfg, p, rms_norm(x, p["norm2"], cfg.norm_eps))[0]
    else:
        shared = params.get("shared")
        if shared is not None:
            shared = layer_params(shared, ("shared",))
        for i, p in enumerate(layers):
            p = layer_params(p, ("layers",))
            y, conv, ssm = mamba_decode(
                cfg, p["mamba"], rms_norm(x, p["norm1"], cfg.norm_eps),
                cache["conv"][i], cache["ssm"][i])
            cache["conv"][i] = conv
            cache["ssm"][i] = ssm
            x = x + y
            if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                site = i // cfg.attn_every
                x = x + attn_decode(
                    cfg, shared["attn"],
                    rms_norm(x, shared["norm1"], cfg.norm_eps),
                    cache["k"][site], cache["v"][site], pos, window=0)
                x = x + mlp(cfg, shared["mlp"],
                            rms_norm(x, shared["norm2"], cfg.norm_eps))
    cache["pos"] = pos + 1
    return _logits(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: int):
    """Run the prompt once: (last-position logits (B, 1, V), a decode cache
    sized ``max_len``). SSM and hybrid families take the final recurrent
    state of every layer from the SSD kernel (one pass, no replay)."""
    b, s = tokens.shape
    x, _, collected = forward_full(cfg, params, tokens, collect_cache=True)
    dev = tokens.device
    if cfg.family in ATTN_FAMILIES:
        k, v = collected
        cache = init_cache(cfg, b, max_len, dtype=k.dtype, device=dev)
    else:
        cache = init_cache(cfg, b, max_len, device=dev)
        states = collected if cfg.family == "ssm" else collected[2]
        plan = current_plan()
        cache["conv"].copy_(states["conv"])
        cache["ssm"].copy_(states["ssm"] if plan is None
                           else plan.cache_slice(states["ssm"]))
        if cfg.family == "hybrid":
            k, v = collected[:2]
    if cfg.family != "ssm":
        cache["k"][:, :, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :, :s] = v.to(cache["v"].dtype)
    cache["pos"] = s
    return _logits(cfg, params, x[:, -1:, :]), cache
