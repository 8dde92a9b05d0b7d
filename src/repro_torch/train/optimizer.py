"""The reference's hand-rolled AdamW (``repro.train.optimizer``) in plain
tensor code: linear warmup + cosine decay, global-norm clipping, and the
weight decay added inside the update, leaf by leaf over the tree in the
reference's leaf order (dict keys sorted). Not ``torch.optim.AdamW``,
whose operations run in another order.

``apply`` updates the parameters and moments in place, each leaf in flat
chunks of ``CHUNK`` elements: the update's temporaries then take one chunk
of memory, not one leaf (a stacked leaf of zamba2-2.7b is 5.8 GB in f32).
Each chunk computes the reference's expressions in the reference's order.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ckpt.checkpoint import tree_leaves, tree_unflatten

#: Elements per chunk of the in-place update (256 MB of f32).
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``, in f32; ``step`` an
    int or an integer tensor (the result lies on its device)."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def zeros_f32(tree: dict) -> dict:
    """A tree of zeroed f32 tensors shaped and placed as ``tree``'s."""
    return tree_unflatten(tree, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in tree_leaves(tree)])


def init_state(params: dict) -> dict:
    """Zeroed f32 moments beside each leaf, and the step count (int32)."""
    dev = tree_leaves(params)[0].device
    return {"m": zeros_f32(params), "v": zeros_f32(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _chunks(t: torch.Tensor):
    return t.view(-1).split(CHUNK)


def sum_sq(g: torch.Tensor) -> torch.Tensor:
    """A leaf's sum of squares in f32, chunk by chunk."""
    return sum(torch.sum(c * c) for c in _chunks(g.float()))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's sum of squares (f32)."""
    total = 0.0
    for g in tree_leaves(tree):
        total = total + sum_sq(g)
    return torch.sqrt(torch.as_tensor(total))


@torch.no_grad()
def apply(cfg: OptConfig, params: dict, grads: dict, state: dict,
          gnorm: torch.Tensor | None = None):
    """One AdamW step with global-norm clipping on f32 leaves. Updates the
    parameters and ``state``'s moments in place; returns (params, state,
    {"grad_norm", "lr"}). ``gnorm`` is the gradients' global norm where
    the caller reckoned it (over a mesh's shards); else it is the norm of
    ``grads``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    for leaf in zip(*(tree_leaves(t) for t in (params, grads, state["m"],
                                               state["v"]))):
        for p, g, m, v in zip(*(_chunks(t) for t in leaf)):
            g = g.float() * scale
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            mhat = m / b1c
            vhat = v / b2c
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
                cfg.weight_decay * p
            p.copy_(p - lr * delta)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
