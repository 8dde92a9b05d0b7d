"""The train step, the reference's ``make_train_fns``
(``repro.train.train_step``) on one card: gradient accumulation over
microbatches in f32, the model's per-layer remat (``cfg.remat``), optional
int8 gradient compression with error feedback, and AdamW.

The reference's ``make_prefill_fn`` and ``make_decode_fn`` serve only its
TPU pod dry-run (``launch/dryrun.py``); the port's serving ``Engine`` fills
their role, so they are not ported."""

from __future__ import annotations

import torch

from ..ckpt.checkpoint import tree_leaves, tree_unflatten
from ..dist.sharding import Policy
from ..models.model import TrainModel
from . import grad_compress, optimizer


def batch_to(batch: dict, device) -> dict:
    """A numpy batch on ``device``: token ids as int64, the mask and the
    encoder-decoder's frames as f32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t.float() if k in ("mask", "frames") else t.long()
    return out


def make_train_fns(model: TrainModel, policy: Policy,
                   opt_cfg: optimizer.OptConfig):
    """Returns (init_state, step).

    ``init_state(seed, device=None)`` -> {"params", "opt": {"m", "v",
    "step"}, "err"?}; ``step(state, batch) -> (state, metrics)`` updates
    the state's tensors in place and returns it with {"loss", "grad_norm",
    "lr"} (0-d tensors on the device). ``batch`` is the data pipeline's
    numpy dict, its leading dimension divisible by ``policy.microbatches``.
    """

    def init_state(seed: int, device=None) -> dict:
        params = model.init(seed, device)
        state = {"params": params, "opt": optimizer.init_state(params)}
        if policy.grad_compress:
            state["err"] = grad_compress.init_error(params)
        return state

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        k = policy.microbatches
        if k <= 1:
            loss = model.loss(params, batch)
            return loss.detach(), list(torch.autograd.grad(loss, leaves))
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        for mb in zip(*(v.chunk(k) for v in batch.values())):
            loss = model.loss(params, dict(zip(batch, mb)))
            for acc, g in zip(g_sum, torch.autograd.grad(loss, leaves)):
                acc.add_(g)
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / k
        return loss_sum * inv, [g.mul_(inv) for g in g_sum]

    def step(state: dict, batch: dict):
        rows = len(batch["tokens"])
        if rows % max(policy.microbatches, 1):
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{policy.microbatches} microbatches")
        params = state["params"]
        loss, grads = grads_of(params, batch_to(batch, model.device))
        if policy.grad_compress:
            with torch.no_grad():
                for i, (g, e) in enumerate(zip(grads,
                                               tree_leaves(state["err"]))):
                    _, _, new_e = grad_compress.quantize(g, e)
                    grads[i] = g.float() + e - new_e
                    e.copy_(new_e)
        # A profiler range, which names the optimizer's share of a traced
        # step (a few microseconds a step without a profiler).
        with torch.profiler.record_function("train.optimizer"):
            params, opt, stats = optimizer.apply(
                opt_cfg, params, tree_unflatten(params, grads), state["opt"])
        state["opt"] = opt
        return state, {"loss": loss, **stats}

    return init_state, step
