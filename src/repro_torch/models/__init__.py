"""Model zoo of the port: the dense, VLM, SSM and hybrid decoder-only
families in PyTorch, with the reference's parameter layout."""

from .common import ModelConfig
from .model import Model, build

__all__ = ["Model", "ModelConfig", "build"]
