"""Model zoo of the port: every assigned architecture family (dense GQA,
MoE, Mamba-2/SSD, hybrid, encoder-decoder, early-fusion VLM) in PyTorch,
with the reference's parameter layout. See models/model.py for the
unified interface."""

from .common import ModelConfig
from .model import EncDecModel, Model, TrainModel, build, build_train

__all__ = ["EncDecModel", "Model", "ModelConfig", "TrainModel", "build",
           "build_train"]
