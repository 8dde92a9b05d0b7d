"""What a launcher needs on each card, reckoned before it allocates
anything: the serve launcher's weights and decode cache, the train
launcher's parameters, gradients and AdamW moments. A config that does not
fit the free memory is refused with its size.

On a mesh of more than one rank (``mesh``, ``policy``) the bytes are one
rank's: its shards of the parameters as ``dist.sharding.param_specs``
splits them (and their compute-dtype copies, gradients and f32 moments),
the largest unit it gathers whole at a time (one layer, the shared block,
the embedding or the head, in the compute dtype, where any of its splits
is gathered before use), and its shards of the decode cache
(``cache_specs``, its rows of the batch). The reference reaches configs
larger than one device by sharding over a mesh
(``src/repro/launch/serve.py:42-51``); the port does too, and on one card
reaches further through the parameter dtype (``--dtype``)."""

from __future__ import annotations

import math

import torch

from ..dist import sharding as shd
from ..models import transformer
from ..models.common import ModelConfig, activation_sharding
from ..models.parallel import plan_for

#: The launchers' ``--dtype`` values: the parameter dtype.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_bytes(cfg: ModelConfig) -> int:
    """``cfg.param_count()`` parameters in ``cfg.dtype``."""
    return cfg.param_count() * cfg.dtype.itemsize


def local_param_count(cfg: ModelConfig, mesh, policy) -> int:
    """The parameters one rank holds on ``mesh`` under ``policy``."""
    plan = plan_for(cfg, mesh, policy)
    if plan is None:
        return cfg.param_count()
    return sum(math.prod(shd.local_shape(mesh, spec, plan.shapes[path]))
               for path, spec in plan.specs.items())


def gathered_count(cfg: ModelConfig, mesh, policy) -> int:
    """The parameters of the largest unit a rank gathers whole before use
    (0 where nothing is gathered): one layer of a stack, the hybrid's
    shared block, the embedding or the head, each at the size its compute
    runs on (the splits over ``model`` that it keeps stay split)."""
    plan = plan_for(cfg, mesh, policy)
    if plan is None:
        return 0
    units: dict = {}
    for path, spec in plan.specs.items():
        stacked = path[0] in plan.stacks
        shape = plan.shapes[path][1:] if stacked else plan.shapes[path]
        spec = spec[1:] if stacked else spec
        nd = len(spec)
        gathered, size = False, 1
        for d, (n, axes) in enumerate(zip(shape, spec)):
            if axes and (path, d - nd) in plan.keep:
                n //= shd.shard_index(mesh, axes)[1]
            elif axes:
                gathered = True
            size *= n
        unit = path[0]
        units.setdefault(unit, [0, False])
        units[unit][0] += size
        units[unit][1] |= gathered
    return max((n for n, g in units.values() if g), default=0)


def serve_bytes(cfg: ModelConfig, batch: int, max_len: int, mesh=None,
                policy=None) -> int:
    """The serve launcher's device bytes for a decoder-only ``cfg``: the
    parameters; where the parameter and compute dtypes differ, the
    compute-dtype copies the model keeps of its weights
    (``models.model._Weights.run_params``, counted for every parameter);
    and the decode cache at (batch, max_len) in the dtypes prefill gives
    it (KV in the compute dtype, the hybrid's in bf16; SSM states f32).
    On a mesh, one rank's bytes (the module's docstring)."""
    n = local_param_count(cfg, mesh, policy)
    need = n * cfg.dtype.itemsize
    if cfg.compute_dtype != cfg.dtype:
        need += n * cfg.compute_dtype.itemsize
    need += gathered_count(cfg, mesh, policy) * cfg.compute_dtype.itemsize
    kv = (cfg.compute_dtype if cfg.family in transformer.ATTN_FAMILIES
          else torch.bfloat16)
    plan = plan_for(cfg, mesh, policy)
    rows = batch
    if plan is not None:
        rows //= shd.shard_index(mesh, plan.batch_axes(batch))[1]
    with activation_sharding(plan):
        cache = transformer.init_cache(cfg, rows, max_len, kv, device="meta")
    return need + sum(t.numel() * t.element_size() for t in cache.values()
                      if isinstance(t, torch.Tensor))


def train_bytes(cfg: ModelConfig, mesh=None, policy=None) -> int:
    """The train launcher's device bytes before activations: the
    parameters and their gradients in ``cfg.dtype``, and AdamW's two
    moments in f32 (``train.optimizer.init_state``); on a mesh one rank's
    shards of them, and the largest unit it gathers in the compute
    dtype."""
    n = local_param_count(cfg, mesh, policy)
    return (2 * n * cfg.dtype.itemsize + 2 * n * 4
            + gathered_count(cfg, mesh, policy) * cfg.compute_dtype.itemsize)


def free_bytes(device: torch.device) -> int | None:
    """Free memory of a CUDA device; None for the CPU (not reckoned)."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[0]


def refuse_unless_fits(cfg: ModelConfig, need: int, free: int | None) -> None:
    """Raise SystemExit, naming the config, the bytes it needs and the free
    bytes, when ``need`` exceeds ``free`` (None: nothing to check)."""
    if free is not None and need > free:
        raise SystemExit(
            f"{cfg.name} does not fit: it needs {need / 1e9:.1f} GB "
            f"({param_bytes(cfg) / 1e9:.1f} GB of "
            f"{str(cfg.dtype).split('.')[-1]} parameters), and "
            f"{free / 1e9:.1f} GB are free")
