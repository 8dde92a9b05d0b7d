"""The step builders of the reference's ``repro.train.train_step``: the
train step (``make_train_fns``: gradient accumulation over microbatches in
f32, the model's per-layer remat, optional int8 gradient compression with
error feedback, AdamW) and the sharded prefill and decode steps
(``make_prefill_fn``, ``make_decode_fn``).

``make_train_fns(model, mesh, policy, opt_cfg)`` takes the reference's
arguments. On a device mesh of more than one rank each rank holds its
shards of the parameters, the AdamW moments and the error feedback, as
``dist.sharding.param_specs`` splits them, and takes its rows of each
microbatch. Its loss is its share
(``models.parallel.ShardPlan.loss``); the backward pass reduce-scatters
the gradients of the weights gathered over the FSDP axes, and each
gradient is then summed over the mesh axes its spec does not split it
over. The f32 gradients are then exactly the whole batch's, reduced, and
``grad_compress`` quantizes them with error feedback after that
reduction, as the reference's step does (``train_step.py:82-98``), the
per-tensor scale taken over the whole tensor. The global gradient norm
and the reported loss are reduced over the mesh. On a one-rank mesh
(``make_host_mesh()`` in one process) the step is the one-device one."""

from __future__ import annotations

import torch

from ..ckpt.checkpoint import tree_leaves, tree_unflatten
from ..dist import collectives as col
from ..dist.sharding import Policy
from ..models.common import activation_sharding
from ..models.model import TrainModel, build_train
from ..tracing import span
from . import grad_compress, optimizer


def batch_to(batch: dict, device) -> dict:
    """A numpy batch on ``device``: token ids as int64, the mask and the
    encoder-decoder's frames as f32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t.float() if k in ("mask", "frames") else t.long()
    return out


def tree_paths(tree, path=()) -> list:
    """The key paths of ``tree``'s leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k],
                                                            path + (k,))]
    return [path]


def sharded_model(model, mesh, policy):
    """``model`` with this rank's layout on ``mesh``: itself when it was
    built for it (or the mesh has one rank), else rebuilt."""
    if mesh.size == 1:
        return model
    if model.plan is not None:
        if model.plan.mesh is not mesh or model.plan.policy != policy:
            raise ValueError("the model was built for another mesh or "
                             "policy")
        return model
    return build_train(model.cfg, model.device, mesh=mesh, policy=policy)


def make_train_fns(model: TrainModel, mesh, policy: Policy, opt_cfg):
    """(init_state, step) of ``model`` on ``mesh`` (``make_host_mesh()``
    in one process: the model's device) under ``policy``.

    ``init_state(seed, device=None)`` -> {"params", "opt": {"m", "v",
    "step"}, "err"?} (this rank's shards on a mesh); ``step(state, batch)
    -> (state, metrics)`` updates the state's tensors in place and returns
    it with {"loss", "grad_norm", "lr"} (0-d tensors on the device, the
    whole batch's). ``batch`` is the data pipeline's numpy dict of the
    whole batch, its leading dimension divisible by
    ``policy.microbatches``."""
    model = sharded_model(model, mesh, policy)
    plan = model.plan

    def init_state(seed: int, device=None) -> dict:
        params = model.init(seed, device)
        state = {"params": params, "opt": optimizer.init_state(params)}
        if policy.grad_compress:
            state["err"] = grad_compress.init_error(params)
        return state

    def rows_of(batch):
        if plan is None:
            return batch
        return {k: plan.batch_local(v) for k, v in batch.items()}

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        k = policy.microbatches
        if k <= 1:
            with activation_sharding(plan):
                loss = model.loss(params, rows_of(batch))
                return loss.detach(), list(torch.autograd.grad(loss, leaves))
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        for mb in zip(*(v.chunk(k) for v in batch.values())):
            mb = rows_of(dict(zip(batch, mb)))
            with activation_sharding(plan):
                loss = model.loss(params, mb)
                grads = torch.autograd.grad(loss, leaves)
            for acc, g in zip(g_sum, grads):
                acc.add_(g)
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / k
        return loss_sum * inv, [g.mul_(inv) for g in g_sum]

    def reduce(params, loss, grads):
        """The whole batch's loss and gradients from this rank's shares,
        and the global gradient norm (None off a mesh)."""
        if plan is None:
            return loss, grads, None
        axes = mesh.axis_names
        paths = tree_paths(params)
        grads = [col.psum_scalar(g.contiguous(), mesh, plan.grad_axes(p))
                 for g, p in zip(grads, paths)]
        loss = col.psum_scalar(loss, mesh, axes)
        return loss, grads, paths

    def global_norm(grads, paths):
        total = torch.zeros((), dtype=torch.float32, device=model.device)
        for g, p in zip(grads, paths):
            total = total + optimizer.sum_sq(g) / plan.replication(p)
        return torch.sqrt(col.psum_scalar(total, mesh, mesh.axis_names))

    def step(state: dict, batch: dict):
        rows = len(batch["tokens"])
        if rows % max(policy.microbatches, 1):
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{policy.microbatches} microbatches")
        params = state["params"]
        loss, grads = grads_of(params, batch_to(batch, model.device))
        loss, grads, paths = reduce(params, loss, grads)
        if policy.grad_compress:
            with torch.no_grad():
                for i, (g, e) in enumerate(zip(grads,
                                               tree_leaves(state["err"]))):
                    absmax = None
                    if plan is not None:
                        absmax = col.pmax(torch.max(torch.abs(g.float() + e)),
                                          mesh, mesh.axis_names)
                    _, _, new_e = grad_compress.quantize(g, e, absmax)
                    grads[i] = g.float() + e - new_e
                    e.copy_(new_e)
        gnorm = None if plan is None else global_norm(grads, paths)
        # A span, which names the optimizer's share of a traced step.
        with span("train.optimizer"):
            params, opt, stats = optimizer.apply(
                opt_cfg, params, tree_unflatten(params, grads), state["opt"],
                gnorm=gnorm)
        state["opt"] = opt
        return state, {"loss": loss, **stats}

    return init_state, step


def make_prefill_fn(model, mesh, policy: Policy):
    """The reference's sharded prefill step: ``prefill(batch)`` with
    ``batch`` {"tokens" (B, S)} (and "frames" for the encoder-decoder),
    the whole batch on every rank -> (this rank's last-position logits,
    its cache shards). The cache is sized ``S`` (``S + 64`` for the
    encoder-decoder), as the reference's."""
    from ..serve.engine import Engine, ServeConfig

    model = Engine(model, mesh, policy, None, ServeConfig()).model
    plan = model.plan

    def prefill(batch: dict):
        if plan is not None:
            batch = {k: plan.batch_local(v) for k, v in batch.items()}
        tokens = batch["tokens"]
        if model.cfg.family == "encdec":
            return model.prefill(batch["frames"], tokens,
                                 tokens.shape[1] + 64)
        return model.prefill(tokens, tokens.shape[1])

    return prefill


def make_decode_fn(model, mesh, policy: Policy):
    """The reference's sharded decode step: ``decode(cache, token)`` with
    this rank's cache shards and the whole batch's (B, 1) tokens -> (this
    rank's logits, the cache updated in place)."""
    from ..serve.engine import Engine, ServeConfig

    model = Engine(model, mesh, policy, None, ServeConfig()).model
    plan = model.plan

    def decode(cache: dict, token: torch.Tensor):
        if plan is not None:
            token = plan.batch_local(token)
        return model.decode_step(cache, token)

    return decode
