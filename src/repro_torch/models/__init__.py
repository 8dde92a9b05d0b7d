"""Model zoo of the port: the dense, VLM, SSM and hybrid decoder-only
families in PyTorch, with the reference's parameter layout."""

from .common import ModelConfig
from .model import Model, TrainModel, build, build_train

__all__ = ["Model", "ModelConfig", "TrainModel", "build", "build_train"]
