"""``repro_torch.noc`` — the unified NoC optimization API of the port::

    from repro_torch.noc import Budget, NocProblem, run, named_spec

    problem = NocProblem(spec=named_spec("64"), traffic="BFS", case="case5")
    result = run(problem, "stage", budget=Budget(max_evals=2000, seed=0))
    result.save("run.json")     # the reference's RunResult JSON format

``run`` executes on ``device="cuda"`` unless told otherwise.
CLI: ``python -m repro_torch.noc run`` (see repro_torch.noc.cli).
"""

from .api import (Budget, BudgetedEvaluator, BudgetExhausted, NocProblem,
                  RunRecorder, RunResult, design_from_json, design_to_json,
                  named_spec, run)
from .optimizers import (OPTIMIZERS, AmosaConfig, LocalConfig, Nsga2Config,
                         OptimizerEntry, PcbbConfig, StageBatchConfig,
                         StageConfig, get_optimizer, make_config,
                         optimizer_names, register)

__all__ = [
    "AmosaConfig", "Budget", "BudgetExhausted", "BudgetedEvaluator",
    "LocalConfig", "NocProblem", "Nsga2Config", "OPTIMIZERS",
    "OptimizerEntry", "PcbbConfig", "RunRecorder", "RunResult",
    "StageBatchConfig", "StageConfig", "design_from_json", "design_to_json",
    "get_optimizer", "make_config", "named_spec", "optimizer_names",
    "register", "run",
]
