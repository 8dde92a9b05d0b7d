"""MOO-STAGE and the 3D heterogeneous NoC design problem (objectives
Eqs. 1-10, Algorithms 1-2) in PyTorch, on an explicit device, plus the
AMOSA / PCBB / NSGA-II baselines (``amosa``, ``pcbb``, ``nsga2``), the
application-agnostic studies (``agnostic``) and the flit simulator
(``netsim``, host numpy)."""

from .evaluate import Evaluator
from .features import design_features, design_features_batch
from .forest import RegressionForest
from .local_search import (ParetoSet, SearchHistory, local_search,
                           local_search_batch)
from .objectives import CASES, N_OBJ, OBJ_NAMES
from .pareto import (ParetoArchive, PhvContext, dominates, hypervolume,
                     pareto_filter, pareto_mask)
from .problem import (CPU, GPU, LLC, Design, SystemSpec, random_design,
                      sample_neighbors, spec_16, spec_36, spec_64, spec_1024,
                      spec_large, spec_tiny)
from .stage import StageBatchResult, StageResult, moo_stage, stage_batch
from .traffic import APP_NAMES, APPLICATIONS, avg_traffic, traffic_matrix

__all__ = [
    "APP_NAMES", "APPLICATIONS", "CASES", "CPU", "Design", "Evaluator", "GPU",
    "LLC", "N_OBJ", "OBJ_NAMES", "ParetoArchive", "ParetoSet", "PhvContext",
    "RegressionForest", "SearchHistory", "StageBatchResult", "StageResult",
    "SystemSpec", "avg_traffic", "design_features", "design_features_batch",
    "dominates", "hypervolume", "local_search", "local_search_batch",
    "moo_stage", "pareto_filter", "pareto_mask", "random_design",
    "sample_neighbors", "spec_16", "spec_36", "spec_64", "spec_1024",
    "spec_large", "spec_tiny", "stage_batch", "traffic_matrix",
]
