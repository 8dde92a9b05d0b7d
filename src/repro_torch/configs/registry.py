"""Architecture registry: the ten assigned architectures (exact public
configs) and their reduced ``SMOKE`` variants, and :func:`input_specs`,
the reference's stand-ins for a step's inputs as meta tensors."""

from __future__ import annotations

import torch

from ..models.common import ModelConfig
from . import (chameleon_34b, deepseek_coder_33b, gemma3_1b, mamba2_1_3b,
               mistral_large_123b, moonshot_v1_16b_a3b, qwen3_moe_30b_a3b,
               whisper_base, yi_6b, zamba2_2_7b)
from .shapes import SHAPES, WHISPER_MAX_TARGET, Shape, applicable, cell_status

_MODULES = {
    "mistral-large-123b": mistral_large_123b,
    "gemma3-1b": gemma3_1b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "yi-6b": yi_6b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "zamba2-2.7b": zamba2_2_7b,
    "mamba2-1.3b": mamba2_1_3b,
    "whisper-base": whisper_base,
    "chameleon-34b": chameleon_34b,
}

ARCH_NAMES = tuple(_MODULES)


#: The port's token ids: the reference's int32 ids are int64 here, the
#: index dtype of the port's embedding lookup and of its loss's gather.
TOKEN_DTYPE = torch.int64


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG


def input_specs(cfg: ModelConfig, shape: Shape, device="meta") -> dict:
    """The inputs of the step of (cfg, shape), the whole batch, as tensors
    on ``device`` (meta: shapes and dtypes only), the reference's tree:

    train   -> {"tokens", "targets"} (+ "frames" for enc-dec)
    prefill -> {"tokens"} (+ "frames")
    decode  -> {"cache": ``init_cache(...)`` on ``device``, "token"}

    Token ids are :data:`TOKEN_DTYPE` (the reference's int32); the cache's
    ``pos`` is the port's Python int 0 (the reference's 0-d int32)."""
    b, s = shape.global_batch, shape.seq_len

    def t(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    if cfg.family == "encdec":
        tgt = min(WHISPER_MAX_TARGET, s)
        if shape.kind == "train":
            return {"frames": t((b, s, cfg.d_model), torch.bfloat16),
                    "tokens": t((b, tgt), TOKEN_DTYPE),
                    "targets": t((b, tgt), TOKEN_DTYPE)}
        if shape.kind == "prefill":
            return {"frames": t((b, s, cfg.d_model), torch.bfloat16),
                    "tokens": t((b, 8), TOKEN_DTYPE)}
        # decode: a self cache of tgt, a cross cache of s (audio frames)
        from ..models import encdec
        cache = encdec.init_cache(cfg, b, tgt, s, torch.bfloat16,
                                  device=device)
        return {"cache": cache, "token": t((b, 1), TOKEN_DTYPE)}

    if shape.kind == "train":
        return {"tokens": t((b, s), TOKEN_DTYPE),
                "targets": t((b, s), TOKEN_DTYPE)}
    if shape.kind == "prefill":
        return {"tokens": t((b, s), TOKEN_DTYPE)}
    # decode: one new token against a seq_len cache.
    from ..models import transformer
    cache = transformer.init_cache(cfg, b, s, torch.bfloat16, device=device)
    return {"cache": cache, "token": t((b, 1), TOKEN_DTYPE)}


__all__ = ["ARCH_NAMES", "SHAPES", "Shape", "TOKEN_DTYPE", "applicable",
           "cell_status", "get_config", "input_specs"]
