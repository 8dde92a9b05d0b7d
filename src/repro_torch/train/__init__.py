"""LLM training on one card or a mesh of them: AdamW, int8 gradient
compression, the train step and the fault-tolerant trainer, as the
reference's ``repro.train``."""

from .optimizer import OptConfig
from .train_step import make_train_fns
from .trainer import TrainConfig, Trainer

__all__ = ["OptConfig", "TrainConfig", "Trainer", "make_train_fns"]
