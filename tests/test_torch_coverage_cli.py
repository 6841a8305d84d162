"""The port's ``evaluate`` on the two configurations that drive the team
instantiations on the card's paths, params/lotkavolterra2 under Kvaerno3 and
params/hodgkinhuxley1_r4 under RKF45 (``--set solver_builder``), against the
JAX CLI: both in float64 on the CPU at a cut horizon (LV tN 0.2; HH tN 0.3,
before the stimulus starts at t = 10, so the two routes' time rules agree),
the full evaluation grids (20 x 20; 100 g_Na points) x 4 stages. The port
takes the kernels' route (their plain versions on the CPU, never
``make_nll``; HH reads the npz copy of its observations) and its objective
equals the JAX CLI's at rtol 1e-9, its grid exactly.
"""

import numpy as np
import pytest

from ode_uncertainty_tpu_torch import run_parameter_estimation as rpe
from test_torch_nll_route_keys import DATA, _cfg, _jax_cli, make_nll_calls  # noqa: F401 (a fixture)


def _solver(name):
    return {"class_path": f"ode_uncertainty_tpu.solvers.{name}", "init_args": {"step_size": 0.01}}


CASES = {
    "lotkavolterra2-kvaerno3": ("params/lotkavolterra2", {"float64": True, "tN": 0.2,
                                                          "solver_builder": _solver("Kvaerno3")}, {}),
    "hodgkinhuxley1_r4-rkf45": ("params/hodgkinhuxley1_r4", {"float64": True, "tN": 0.3,
                                                             "solver_builder": _solver("RKF45")},
                                {"y_path": str(DATA / "hodgkinhuxley_r4.npz")}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_on_the_kernels_route_matches_jax_cli(tmp_path, make_nll_calls, case):
    experiment, settings, port_only = CASES[case]
    res = rpe.evaluate(_cfg(tmp_path, experiment, settings, **port_only))
    assert res["route"] == "nll_fwd kernel" and make_nll_calls == []
    assert res["nll_evals"].shape == (4, 400 if "lotka" in experiment else 100)
    assert np.isfinite(res["nll_evals"]).all()
    ref = _jax_cli(tmp_path, "evaluate", experiment, settings)
    np.testing.assert_array_equal(res["param_evals"], ref["param_evals"])
    np.testing.assert_allclose(res["nll_evals"], ref["nll_evals"], rtol=1e-9, atol=0.0)
