"""The ten assigned architectures (exact public configs) and the four input
shapes."""

from .registry import ARCH_NAMES, SHAPES, applicable, cell_status, get_config
from .shapes import Shape

__all__ = ["ARCH_NAMES", "SHAPES", "Shape", "applicable", "cell_status",
           "get_config"]
