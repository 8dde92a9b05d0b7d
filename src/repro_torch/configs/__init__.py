"""The ten assigned architectures (exact public configs) and the four input
shapes, and the stand-ins for a step's inputs (:func:`input_specs`)."""

from .registry import (ARCH_NAMES, SHAPES, TOKEN_DTYPE, applicable,
                       cell_status, get_config, input_specs)
from .shapes import Shape

__all__ = ["ARCH_NAMES", "SHAPES", "Shape", "TOKEN_DTYPE", "applicable",
           "cell_status", "get_config", "input_specs"]
