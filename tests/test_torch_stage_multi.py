"""Multi-iteration MOO-STAGE on the CPU against the JAX reference: several
local searches and meta searches (spec_tiny, 4 local steps, 500
evaluations), seeds 0/1/2, on the all-host meta path with the numpy forest
and on the fused meta path. The port's front must be the reference's:
the same designs, rows within rtol 1e-5.

These runs cross many accept decisions, so they hold only because the
port's CPU objective rows come within a few f32 ulps of the reference's
(its walk accumulates in the reference's scatter order and its sums run
left to right, as XLA:CPU's do on small dimensions)."""

import numpy as np
import pytest

import repro.noc as ref_noc
from repro_torch.noc import Budget, NocProblem, named_spec, run


def _same_front(a, b):
    assert [d.key() for d in a.designs] == [d.key() for d in b.designs]
    np.testing.assert_allclose(a.objs, b.objs, rtol=1e-5, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("meta_backend,forest_backend", [
    ("host", "numpy"), ("fused", "auto")])
def test_multi_iteration_front_matches_reference(seed, meta_backend,
                                                 forest_backend):
    config = {"max_local_steps": 4, "meta_backend": meta_backend}
    res = run(NocProblem(spec=named_spec("tiny"), traffic="BFS",
                         case="case5", forest_backend=forest_backend),
              "stage", budget=Budget(max_evals=500, seed=seed),
              config=config, device="cpu")
    ref = ref_noc.run(
        ref_noc.NocProblem(spec=ref_noc.named_spec("tiny"), traffic="BFS",
                           case="case5", forest_backend=forest_backend),
        "stage", budget=ref_noc.Budget(max_evals=500, seed=seed),
        config=config)
    assert res.extra["n_local_searches"] == ref.extra["n_local_searches"] > 1
    _same_front(res, ref)
    assert (res.n_evals, res.n_calls) == (ref.n_evals, ref.n_calls)
