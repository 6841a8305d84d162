"""The port's entry points never drop an estimation flag: with
``initial_state_parametrized`` both ``evaluate`` and ``optimize`` take the
port's ``make_nll`` (which builds each lane's initial state from its
parameters) and pass the flag on, and ``parameter_sensitivity``, which is not
ported yet, raises on either route. Without the flags the kernels' route is
taken. Lotka-Volterra at a cut horizon, on the CPU.
"""

import pytest

from ode_uncertainty_tpu_torch import run_parameter_estimation as rpe
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment


def _cfg(tmp_path, **overrides):
    raw = load_experiment("params/lotkavolterra2")
    return build_config(raw, {"device": "cpu", "float64": True, "tN": 0.05, "num_random_runs": 0,
                              "num_tempering_stages": 2, "lbfgs_maxiter": 2,
                              "num_param_evals": {"alpha": 3, "beta": 2, "gamma": 1, "delta": 1},
                              "output": str(tmp_path / "out.npz"), **overrides})


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


@pytest.mark.parametrize("command", ["evaluate", "optimize"])
@pytest.mark.parametrize("init_param", [False, True])
def test_parameter_sensitivity_raises_on_both_routes(tmp_path, command, init_param):
    cfg = _cfg(tmp_path, parameter_sensitivity=True, initial_state_parametrized=init_param)
    with pytest.raises(NotImplementedError, match="parameter_sensitivity"):
        getattr(rpe, command)(cfg)
    assert not (tmp_path / "out.npz").exists()
