"""Unified model interface: ``build(cfg) -> Model`` (``EncDecModel`` for
the encoder-decoder family), an ``nn.Module`` that holds the parameters on
one explicit device and serves ``prefill`` / ``decode_step`` /
``init_cache``; ``build_train(cfg) -> TrainModel``, the reference's
``init`` / ``loss`` pair that the train step builds on.

Both take a device ``mesh`` and a sharding ``policy``: on a mesh of more
than one rank the model holds this rank's shards of every parameter
(``models.parallel.ShardPlan``; drawn whole layer by layer from the same
seed as one process draws them, and cut as they are drawn, or cut from
the whole tree it is given) and runs its methods under that plan. On a
one-rank mesh, or none, there is no plan: the meshless path, bit for
bit.

On the ``"meta"`` device a model holds its tree's shapes and dtypes and
allocates nothing: the pod tools (``launch/dryrun.py``) run one rank's
step on it. ``abstract_params()`` is the reference's
``Model.abstract_params``: the parameter tree on the meta device."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import resolve_device
from . import encdec, transformer
from .common import MetaGenerator, ModelConfig, activation_sharding
from .parallel import ShardPlan, plan_for

#: Leaves the reference casts to the compute dtype at every use (matmul
#: weights, the experts' too, the conv, the embedding). The model casts
#: them once: the same values, without a cast per call. The MoE router
#: stays f32.
_CAST = frozenset({"wq", "wk", "wv", "wo", "w1", "w2", "w3", "in_proj",
                   "out_proj", "conv_w", "conv_b", "embed", "head"})


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", k, v


def _model_device(device) -> torch.device:
    """``device`` as :func:`resolve_device` takes it, or the meta device
    (shapes only)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    if dev.type == "meta":
        return MetaGenerator()
    return torch.Generator(device=dev).manual_seed(seed)


def _abstract_params(cfg: ModelConfig, plan) -> dict:
    """The parameter tree of ``cfg`` on the meta device (this rank's shards
    under ``plan``)."""
    with torch.no_grad(), activation_sharding(plan):
        return _family(cfg).init_params(cfg, MetaGenerator())


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(k, v)
            for k, v in tree.items()}


class _Weights(nn.Module):
    """The parameters on one device. ``params`` is the reference's tree
    (stacked layer leaves) in the parameter dtype; the leaves the reference
    casts to the compute dtype are kept cast once, in ``run_params`` (the
    same tensors where the two dtypes agree)."""

    def __init__(self, cfg: ModelConfig, params: dict, device,
                 plan: ShardPlan | None = None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.device = torch.device(device)
        self.params = _map(params, lambda k, v: v.to(self.device))
        for path, _, v in _leaves(self.params):
            self.register_buffer(path.replace(".", "__"), v, persistent=True)
        cd = cfg.compute_dtype
        self.run_params = _map(
            self.params, lambda k, v: v.to(cd) if k in _CAST else v)

    def abstract_params(self) -> dict:
        """The parameter tree's shapes and dtypes on the meta device, as
        the reference's ``Model.abstract_params`` (this rank's shards on a
        mesh)."""
        return _abstract_params(self.cfg, self.plan)


class Model(_Weights):
    """A decoder-only LM of the dense / VLM / MoE / SSM / hybrid families.
    Every method runs under ``torch.inference_mode``."""

    def __init__(self, cfg: ModelConfig, params: dict, device,
                 plan: ShardPlan | None = None):
        transformer.check_family(cfg)
        super().__init__(cfg, params, device, plan)

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, max_len: int):
        """tokens (B, S) -> (last-position logits (B, 1, V), cache). On a
        mesh: this rank's rows, and the logits of its share of the
        vocabulary where the head is split."""
        with activation_sharding(self.plan):
            return transformer.prefill(self.cfg, self.run_params,
                                       tokens.to(self.device), max_len)

    @torch.inference_mode()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, 1, V), cache updated in place)."""
        with activation_sharding(self.plan):
            return transformer.decode_step(self.cfg, self.run_params, cache,
                                           tokens.to(self.device))

    @torch.inference_mode()
    def forward_full(self, tokens: torch.Tensor):
        """Hidden states (B, S, D) of a full-sequence pass."""
        with activation_sharding(self.plan):
            return transformer.forward_full(self.cfg, self.run_params,
                                            tokens.to(self.device))[0]

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        with activation_sharding(self.plan):
            return transformer.init_cache(self.cfg, batch, max_len, dtype,
                                          device=self.device)


class EncDecModel(_Weights):
    """A whisper-style encoder-decoder: the encoder reads stub frame
    embeddings (B, S_enc, D). Every method runs under
    ``torch.inference_mode``."""

    def __init__(self, cfg: ModelConfig, params: dict, device,
                 plan: ShardPlan | None = None):
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDecModel takes the encdec "
                             f"family, got {cfg.family}")
        super().__init__(cfg, params, device, plan)

    @torch.inference_mode()
    def encode(self, frames: torch.Tensor):
        """frames (B, S_enc, D) -> encoder states (B, S_enc, D)."""
        with activation_sharding(self.plan):
            return encdec.encode(self.cfg, self.run_params,
                                 frames.to(self.device))

    @torch.inference_mode()
    def prefill(self, frames: torch.Tensor, tokens: torch.Tensor,
                max_len: int):
        """frames (B, S_enc, D), tokens (B, S) -> (last-position logits
        (B, 1, V), cache)."""
        with activation_sharding(self.plan):
            return encdec.prefill(self.cfg, self.run_params,
                                  frames.to(self.device),
                                  tokens.to(self.device), max_len)

    @torch.inference_mode()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, 1, V), cache updated in place)."""
        with activation_sharding(self.plan):
            return encdec.decode_step(self.cfg, self.run_params, cache,
                                      tokens.to(self.device))

    def init_cache(self, batch: int, max_len: int, enc_len: int = 0,
                   dtype=torch.bfloat16):
        with activation_sharding(self.plan):
            return encdec.init_cache(self.cfg, batch, max_len, enc_len,
                                     dtype, device=self.device)


def _family(cfg: ModelConfig):
    """The module of ``cfg``'s family: ``encdec`` or ``transformer``."""
    if cfg.family == "encdec":
        return encdec
    transformer.check_family(cfg)
    return transformer


def build(cfg: ModelConfig, params: dict | None = None, *, seed: int = 0,
          device=None, mesh=None, policy=None) -> Model | EncDecModel:
    """The model of ``cfg`` on ``device`` (a CUDA device unless the caller
    asks for the CPU or ``"meta"``). Without ``params`` the weights are
    drawn from a ``torch.Generator`` seeded with ``seed`` on that device.
    On a ``mesh`` of more than one rank it holds this rank's shards under
    ``policy``
    (the default ``Policy()`` when None): drawn whole, layer by layer, and
    cut as they are drawn, or cut from the whole tree ``params``."""
    fam = _family(cfg)
    dev = _model_device(device)
    plan = plan_for(cfg, mesh, policy)
    if params is None:
        gen = _generator(dev, seed)
        with torch.inference_mode(), activation_sharding(plan):
            params = fam.init_params(cfg, gen)
    elif plan is not None:
        params = plan.local(params)
    return (EncDecModel if fam is encdec else Model)(cfg, params, dev, plan)


@dataclasses.dataclass(frozen=True)
class TrainModel:
    """The training side of a model, the reference's ``Model.init`` /
    ``Model.loss`` over parameter trees whose leaves are tensors on
    ``device`` that require grad. It holds no weights and no cast copies:
    the serving model's ``run_params`` would go stale after an optimizer
    step."""

    cfg: ModelConfig
    device: torch.device
    #: This rank's layout on a mesh; None on one rank.
    plan: ShardPlan | None = dataclasses.field(default=None, compare=False)

    def init(self, seed: int, device=None) -> dict:
        """Fresh parameters drawn from a ``torch.Generator`` seeded with
        ``seed`` on ``device`` (the model's by default; ``"meta"`` builds
        the tree's shapes and dtypes only). Drawn under ``no_grad``, not
        ``inference_mode``: autograd must be able to save them."""
        dev = self.device if device is None else torch.device(device)
        gen = _generator(dev, seed)
        with torch.no_grad(), activation_sharding(self.plan):
            params = _family(self.cfg).init_params(self.cfg, gen)
        for _, _, v in _leaves(params):
            v.requires_grad_(True)
        return params

    def abstract_params(self) -> dict:
        """``init(0, "meta")``: the reference's ``Model.abstract_params``."""
        return self.init(0, "meta")

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """The scalar training loss of ``batch`` (tensors on the device;
        the encoder-decoder's holds ``"frames"`` too). On a mesh: this
        rank's share (``ShardPlan.loss``); call it, and differentiate it,
        inside ``activation_sharding(self.plan)``."""
        with activation_sharding(self.plan):
            return _family(self.cfg).loss_fn(self.cfg, params, batch)


def build_train(cfg: ModelConfig, device=None, *, mesh=None,
                policy=None) -> TrainModel:
    """The training model of ``cfg`` on ``device`` (a CUDA device unless
    the caller asks for the CPU or ``"meta"``), holding this rank's shards on a ``mesh``
    of more than one rank."""
    _family(cfg)
    return TrainModel(cfg, _model_device(device),
                      plan_for(cfg, mesh, policy))
