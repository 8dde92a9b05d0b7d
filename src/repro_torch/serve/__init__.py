"""Batched greedy serving on one device or a mesh of them."""

from .engine import Engine, ServeConfig

__all__ = ["Engine", "ServeConfig"]
