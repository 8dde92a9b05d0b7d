"""Architecture registry: the ten assigned architectures (exact public
configs) and their reduced ``SMOKE`` variants."""

from __future__ import annotations

from ..models.common import ModelConfig
from . import (chameleon_34b, deepseek_coder_33b, gemma3_1b, mamba2_1_3b,
               mistral_large_123b, moonshot_v1_16b_a3b, qwen3_moe_30b_a3b,
               whisper_base, yi_6b, zamba2_2_7b)
from .shapes import SHAPES, Shape, applicable, cell_status

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


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCH_NAMES", "SHAPES", "Shape", "applicable", "cell_status",
           "get_config"]
