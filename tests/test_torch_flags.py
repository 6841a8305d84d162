"""The port's entry points never drop an estimation flag: with
``initial_state_parametrized`` both ``evaluate`` and ``optimize`` take the
port's ``make_nll`` (which builds each lane's initial state from its
parameters) and pass the flag on; with ``parameter_sensitivity`` (the
per-lane process-noise weights, which the kernels do not compute) they take
``make_nll`` too, and their results equal the JAX CLI's (float64, the
tolerances of tests/test_torch_optimize.py: NLLs rtol 1e-8 for ``optimize``
and 1e-9 for ``evaluate``, optima atol 1e-6, grids and counters exactly).
Without the flags the kernels' route is taken. Lotka-Volterra at a cut
horizon (tN 0.05), on the CPU.
"""

import json

import h5py
import numpy as np
import pytest

from ode_uncertainty_tpu_torch import run_parameter_estimation as rpe
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment
from test_torch_optimize import REPO, _run

SETTINGS = {"float64": True, "tN": 0.05, "num_random_runs": 0, "num_tempering_stages": 2, "lbfgs_maxiter": 2,
            "num_param_evals": {"alpha": 3, "beta": 2, "gamma": 1, "delta": 1}}


def _cfg(tmp_path, **overrides):
    raw = load_experiment("params/lotkavolterra2")
    return build_config(raw, {"device": "cpu", **SETTINGS, "output": str(tmp_path / "out.npz"), **overrides})


@pytest.fixture
def make_nll_calls(monkeypatch):
    calls = []
    real = rpe.make_nll

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(rpe, "make_nll", spy)
    return calls


@pytest.mark.parametrize("command", ["evaluate", "optimize"])
def test_initial_state_parametrized_takes_make_nll(tmp_path, make_nll_calls, command):
    res = getattr(rpe, command)(_cfg(tmp_path, initial_state_parametrized=True))
    assert res["route"] == {"evaluate": "make_nll", "optimize": "make_nll + autograd"}[command]
    assert [c["initial_state_parametrized"] for c in make_nll_calls] == [True]


@pytest.mark.parametrize("command", ["evaluate", "optimize"])
def test_without_flags_the_kernels_route_is_taken(tmp_path, make_nll_calls, command):
    res = getattr(rpe, command)(_cfg(tmp_path))
    assert res["route"] == {"evaluate": "nll_fwd kernel", "optimize": "nll_fwd + nll_bwd kernels"}[command]
    assert make_nll_calls == []


def _jax_cli(tmp_path, command, **overrides):
    """The JAX CLI's results for the same settings (its own process, CPU)."""
    out = tmp_path / "jax.h5"
    sets = [a for k, v in {**SETTINGS, **overrides}.items() for a in ("--set", f"{k}={json.dumps(v)}")]
    _run(["run_parameter_estimation.py", command, "--experiment", "params/lotkavolterra2", *sets,
          "--set", "platform=cpu", "--set", f"output={out}"], cwd=REPO / "scripts", home=tmp_path)
    with h5py.File(out, "r") as f:
        return {k: f[k][()] for k in f}


@pytest.mark.parametrize("command", ["evaluate", "optimize"])
@pytest.mark.parametrize("init_param", [False, True])
def test_parameter_sensitivity_raises_on_both_routes(tmp_path, make_nll_calls, command, init_param):
    flags = {"parameter_sensitivity": True, "initial_state_parametrized": init_param}
    res = getattr(rpe, command)(_cfg(tmp_path, **flags))
    assert res["route"] == {"evaluate": "make_nll", "optimize": "make_nll + autograd"}[command]
    assert [(c["parameter_sensitivity"], c["initial_state_parametrized"]) for c in make_nll_calls] == [
        (True, init_param)]
    ref = _jax_cli(tmp_path, command, **flags)
    if command == "evaluate":
        np.testing.assert_array_equal(res["param_evals"], ref["param_evals"])
        assert res["nll_evals"].shape == (2, 6)
        np.testing.assert_allclose(res["nll_evals"], ref["nll_evals"], rtol=1e-9, atol=0.0)
    else:
        for key in ("params_inits", "num_lbfgs_iters", "num_nll_evals"):
            np.testing.assert_array_equal(res[key], ref[key], err_msg=key)
        assert res["params_optims"].shape == (1, 2, 2)
        np.testing.assert_allclose(res["params_optims"], ref["params_optims"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(res["nll_optims"], ref["nll_optims"], rtol=1e-8)
