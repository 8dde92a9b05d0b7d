"""Shared model substrate: the config, initialization, norms, RoPE and the
loss.

The reference's models are functional JAX over parameter pytrees; the
port keeps the same nested-dict layout (stacked ``(L, ...)`` layer leaves)
so one tree converts into the other leaf for leaf. The sharding hook
(:func:`activation_sharding`, :func:`pshard`, :func:`layer_params`) is
the reference's: with no plan installed every hook returns its input, and
on a mesh ``models.parallel.ShardPlan`` puts the collectives where they
mark. Layers run in a Python loop, so the
reference's ``unroll_layers`` has no counterpart; ``remat`` means what it
means there: the training loss recomputes each layer's activations in the
backward pass (serving ignores it)."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config describes every assigned architecture (configs/<id>.py)."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # Attention pattern.
    sliding_window: int = 0        # 0 -> full attention
    global_every: int = 0          # gemma3: layer l is global iff (l+1) % global_every == 0
    # MoE.
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba-2 / SSD).
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    conv_width: int = 4
    # Hybrid (zamba2-style): one SHARED attention block every attn_every layers.
    attn_every: int = 0
    # Encoder-decoder (whisper-style).
    encoder_layers: int = 0
    # Frontend stubs ([audio]/[vlm] — the task specifies backbone-only).
    frontend: str = ""             # "" | "audio_stub" | "vq_stub"
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: Any = torch.float32     # parameter dtype
    compute_dtype: Any = torch.bfloat16
    remat: bool = True             # per-layer activation recompute (training)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, v = self.d_model, self.vocab
        hd = self.resolved_head_dim
        total = v * d + d * v + d  # embed + head + final norm

        def attn_params():
            return d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + \
                hd * self.n_heads * d + 2 * d

        def mlp_params(ff):
            return 3 * d * ff
        if self.family in ("dense", "vlm"):
            total += self.n_layers * (attn_params() + mlp_params(self.d_ff)
                                      + 2 * d)
        elif self.family == "moe":
            per = attn_params() + 2 * d + d * self.n_experts \
                + self.n_experts * 3 * d * self.moe_d_ff
            total += self.n_layers * per
        elif self.family == "ssm":
            total += self.n_layers * (self._mamba_params() + d)
        elif self.family == "hybrid":
            total += self.n_layers * (self._mamba_params() + d)
            total += attn_params() + mlp_params(self.d_ff) + 2 * d
        elif self.family == "encdec":
            total += self.encoder_layers * (attn_params()
                                            + mlp_params(self.d_ff) + 2 * d)
            total += self.n_layers * (2 * attn_params()
                                      + mlp_params(self.d_ff) + 3 * d)
        return int(total)

    def _mamba_params(self) -> int:
        h, p, n = self.ssm_heads, self.ssm_head_dim, self.ssm_state
        d_in = h * p
        d = self.d_model
        # in_proj -> (z, x, B, C, dt) ; out_proj ; conv over (x,B,C) ; A, D, norm
        return d * (2 * d_in + 2 * n + h) + d_in * d + \
            self.conv_width * (d_in + 2 * n) + 2 * h + d_in

    def active_param_count(self) -> int:
        """MoE: parameters touched per token (6*N_active*D flops rule)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense_per_layer = (
            d * self.resolved_head_dim * (self.n_heads + 2 * self.n_kv_heads)
            + self.resolved_head_dim * self.n_heads * d + 2 * d
            + d * self.n_experts
        )
        act_moe = self.top_k * 3 * d * self.moe_d_ff
        return int(
            self.vocab * d * 2 + d
            + self.n_layers * (dense_per_layer + act_moe)
        )


# ------------------------------------------------------------------- layers
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32 with the ``(1 + scale)`` gain, back in x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on concatenated halves: x (..., S, H, D),
    positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None].float() * freqs        # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device. The init functions put
    their tensors on ``gen.device``, so with this one they build a parameter
    tree's structure, shapes and dtypes and allocate nothing."""

    device = torch.device("meta")


def stack_layers(n: int, draw, name: str = "layers") -> dict:
    """``n`` layer trees, drawn one at a time by ``draw()``, as one tree of
    stacked ``(n, ...)`` leaves. Each stacked leaf is allocated once and
    filled layer by layer, so one layer's tree is the only other copy held
    (the whole model need not fit twice). Under a shard plan each drawn
    layer is cut to this rank's shards first (``name`` is the stack's key
    in the parameter tree)."""
    def rows(path):
        """This rank's (first, count) of a stack whose layer dim the plan
        splits, else all n."""
        got = None if _PLAN is None else _PLAN.stack_rows(path)
        return (0, n) if got is None else got

    def empty(tree, path):
        if isinstance(tree, dict):
            return {k: empty(v, path + (k,)) for k, v in tree.items()}
        return torch.empty((rows(path)[1], *tree.shape), dtype=tree.dtype,
                           device=tree.device)

    def put(out, tree, i, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(out[k], v, i, path + (k,))
                continue
            first, count = rows(path + (k,))
            if first <= i < first + count:
                out[k][i - first] = v

    out = None
    for i in range(n):
        tree = draw()
        if _PLAN is not None:
            tree = _PLAN.local(tree, (name,))
        if out is None:
            out = empty(tree, (name,))
        put(out, tree, i, (name,))
    return out


def init_dense(gen: torch.Generator, shape, scale_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn from ``gen`` on its device (on
    the meta device, the shape and dtype alone)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[scale_axis]
    w = torch.randn(shape, generator=gen, device=gen.device)
    return (w * (fan_in ** -0.5)).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in f32: logits (..., V), integer labels
    (...); with ``mask``, the masked mean, its denominator at least 1."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# --------------------------------------------------------------- sharding hook
#: The installed ``models.parallel.ShardPlan``, or None. A module global,
#: not a thread-local: autograd recomputes remat'd layers on its own
#: thread in the backward pass, and they must see the same plan.
_PLAN = None


@contextlib.contextmanager
def activation_sharding(plan):
    """Install a shard plan for the model code run inside (the backward
    pass of a training step included); None installs nothing."""
    global _PLAN
    prev = _PLAN
    _PLAN = plan
    try:
        yield
    finally:
        _PLAN = prev


def current_plan():
    return _PLAN


def pshard(x: torch.Tensor, where: str, seq: bool = False) -> torch.Tensor:
    """Mark a block boundary of the residual stream: ``"in"`` before a
    block's first products (the sequence gathered when ``seq``, the
    stream split along the sequence), ``"partial"`` after a row-parallel
    product (summed over the model axis), ``"whole"`` after a block whose
    output every rank computed whole. Without a plan, ``x``."""
    if _PLAN is None:
        return x
    if where == "in":
        return _PLAN.enter(x, seq)
    return _PLAN.exit(x, where == "partial", seq)


def layer_stack(stack: dict, name: str) -> dict:
    """A stack of layers (``params[name]``) ready to split into layers:
    leaves whose layer dim the plan splits gathered along it. Without a
    plan, ``stack``."""
    if _PLAN is None:
        return stack
    return _PLAN.gather_stack(stack, (name,))


def layer_params(p: dict, prefix: tuple) -> dict:
    """A layer's (or the top level's) weights ready for its compute: the
    splits the plan does not keep gathered. Without a plan, ``p``."""
    if _PLAN is None:
        return p
    return _PLAN.gather(p, prefix)


def local_params(tree: dict) -> dict:
    """The top-level (unstacked) leaves of a drawn parameter tree cut to
    this rank's shards under a shard plan; ``tree`` as it is without one.
    Stacked leaves were cut as they were drawn (:func:`stack_layers`)."""
    if _PLAN is None:
        return tree
    return {k: v if k in _PLAN.stacks else _PLAN.local({k: v}, ())[k]
            for k, v in tree.items()}
