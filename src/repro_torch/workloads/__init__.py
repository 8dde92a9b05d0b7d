"""repro_torch.workloads — model-derived NoC traffic.

Derives (N, N) flit-rate matrices from the repo's real model configs:
`mapping` places a logical (data, model) mesh onto a SystemSpec's
heterogeneous tiles, `traffic_model` turns sharded collective volumes into
per-phase matrices in the `core/traffic.py` convention, `phases` sequences
them into traces with phase-weighted scoring, and `study` cross-executes
paper-app-optimized NoCs against LLM traffic (and vice versa).

Every (model x phase) scenario is addressable by string ("arch:phase",
see `PHASE_APP_NAMES`), through `NocProblem(traffic={"model": ...})`, and
through the CLI as ``--traffic model:<arch>:<phase>``.
"""

from .mapping import Mapping, WorkloadMesh, derive_mesh, place_model
from .phases import (Phase, PhaseTrace, WORKLOADS, evaluator_for,
                     link_walk_inputs, phase_weighted_edp, trace_for,
                     trace_link_report, trace_matrices)
from .study import (LLM_STUDY_SCENARIOS, format_cross_table,
                    run_cross_workload_study)
from .traffic_model import (PHASE_APP_NAMES, PHASE_INTENSITY, PHASES,
                            check_scenario, normalize_model_traffic,
                            parse_scenario, scenario_matrix, scenario_name,
                            traffic_from_model)

__all__ = [
    "LLM_STUDY_SCENARIOS", "Mapping", "PHASES", "PHASE_APP_NAMES",
    "PHASE_INTENSITY", "Phase", "PhaseTrace", "WORKLOADS", "WorkloadMesh",
    "check_scenario", "derive_mesh", "evaluator_for", "format_cross_table",
    "link_walk_inputs",
    "normalize_model_traffic", "parse_scenario", "phase_weighted_edp",
    "place_model", "run_cross_workload_study", "scenario_matrix",
    "scenario_name", "trace_for", "trace_link_report", "trace_matrices",
    "traffic_from_model",
]
