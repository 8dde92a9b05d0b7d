"""Batched greedy serving on one device."""

from .engine import Engine, ServeConfig

__all__ = ["Engine", "ServeConfig"]
