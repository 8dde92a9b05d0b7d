"""The benchmark's plain reference: NumPy float64, independent of the
program. :mod:`.noc` computes a design's objective row from its placement
and links; :mod:`.pareto` filters fronts and measures their hypervolume."""

from .noc import INF, OBJ_NAMES, PRECISIONS, System, objectives, round_bf16
from .pareto import REF_SCALE, front_phv, hypervolume, pareto_mask

__all__ = ["INF", "OBJ_NAMES", "PRECISIONS", "REF_SCALE", "System",
           "front_phv", "hypervolume", "objectives", "pareto_mask",
           "round_bf16"]
