"""What a launcher needs on the device, reckoned before it allocates
anything: the serve launcher's weights and decode cache, the train
launcher's parameters, gradients and AdamW moments. A config that does not
fit the free memory is refused with its size.

The reference reaches configs larger than one device by sharding f32
parameters over a mesh (``src/repro/launch/serve.py:42-51``); on one card
the port reaches them through the parameter dtype (``--dtype``)."""

from __future__ import annotations

import torch

from ..models import transformer
from ..models.common import ModelConfig

#: The launchers' ``--dtype`` values: the parameter dtype.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_bytes(cfg: ModelConfig) -> int:
    """``cfg.param_count()`` parameters in ``cfg.dtype``."""
    return cfg.param_count() * cfg.dtype.itemsize


def serve_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    """The serve launcher's device bytes for a decoder-only ``cfg``: the
    parameters; where the parameter and compute dtypes differ, the
    compute-dtype copies the model keeps of its weights
    (``models.model._Weights.run_params``, counted for every parameter);
    and the decode cache at (batch, max_len) in the dtypes prefill gives
    it (KV in the compute dtype, the hybrid's in bf16; SSM states f32)."""
    need = param_bytes(cfg)
    if cfg.compute_dtype != cfg.dtype:
        need += cfg.param_count() * cfg.compute_dtype.itemsize
    kv = (cfg.compute_dtype if cfg.family in transformer.ATTN_FAMILIES
          else torch.bfloat16)
    cache = transformer.init_cache(cfg, batch, max_len, kv, device="meta")
    return need + sum(t.numel() * t.element_size() for t in cache.values()
                      if isinstance(t, torch.Tensor))


def train_bytes(cfg: ModelConfig) -> int:
    """The train launcher's device bytes before activations: the
    parameters and their gradients in ``cfg.dtype``, and AdamW's two
    moments in f32 (``train.optimizer.init_state``)."""
    return 2 * param_bytes(cfg) + 2 * cfg.param_count() * 4


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
