"""Synthetic LM data for the port's trainer (numpy, seeded)."""

from .pipeline import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
