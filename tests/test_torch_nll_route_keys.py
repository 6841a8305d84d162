"""The port's estimation CLI honours the JAX CLI's route keys: with
``--set nll_fast_path=false`` or ``--set nll_impl=xla`` both ``evaluate``
and ``optimize`` take the port's ``make_nll`` (``nll_fast_path`` reaching
it as ``fast_path``) and record that route, and ``evaluate`` then equals
the JAX CLI's objective (float64 rtol 1e-9) on Lotka-Volterra at a cut
horizon (tN 0.05). Without the keys the kernels are the default (their
plain versions on the CPU), as on ``params/pendulum`` with the
covariance-free filter, whose ``evaluate`` at tN 0.2 (the port on the npz
copy of its observations) equals the JAX CLI's XLA ``make_nll`` at 1e-9.
The npz copies of the shipped ``results/noise_gt`` traces that the card
reads equal their H5 files bit for bit.
"""

import json

import h5py
import numpy as np
import pytest

from ode_uncertainty_tpu_torch import run_parameter_estimation as rpe
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment
from test_torch_optimize import REPO, _run

DATA = REPO / "ode_uncertainty_tpu_torch" / "data"
LV = {"float64": True, "tN": 0.05, "num_random_runs": 0, "num_tempering_stages": 2, "lbfgs_maxiter": 2,
      "num_param_evals": {"alpha": 3, "beta": 2, "gamma": 1, "delta": 1}}
# the covariance-free filter: the kernels' configuration (Python literal
# syntax, which both YAML and the card machine's literal parser read)
NO_COV = {"class_path": "SQRT_EKF", "init_args": {"disable_cov_update": True}}
PENDULUM = {"float64": True, "tN": 0.2, "num_param_evals": {"length": 25}, "filter_builder": NO_COV}
ROUTE_KEYS = [{"nll_fast_path": False}, {"nll_impl": "xla"}]


def _cfg(tmp_path, experiment, settings, **overrides):
    raw = load_experiment(experiment)
    return build_config(raw, {"device": "cpu", **settings, "output": str(tmp_path / "out.npz"), **overrides})


def _jax_cli(tmp_path, command, experiment, settings):
    """The JAX CLI's results (its own process, CPU, float64)."""
    out = tmp_path / "jax.h5"
    sets = [a for k, v in settings.items() for a in ("--set", f"{k}={json.dumps(v)}")]
    _run(["run_parameter_estimation.py", command, "--experiment", experiment, *sets,
          "--set", "platform=cpu", "--set", f"output={out}"], cwd=REPO / "scripts", home=tmp_path)
    with h5py.File(out, "r") as f:
        return {k: f[k][()] for k in f}


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
@pytest.mark.parametrize("key", ROUTE_KEYS, ids=["nll_fast_path=false", "nll_impl=xla"])
def test_route_key_takes_make_nll(tmp_path, make_nll_calls, command, key):
    res = getattr(rpe, command)(_cfg(tmp_path, "params/lotkavolterra2", LV, **key))
    assert res["route"] == {"evaluate": "make_nll", "optimize": "make_nll + autograd"}[command]
    assert [c["fast_path"] for c in make_nll_calls] == [key.get("nll_fast_path", True)]
    assert np.isfinite(res["nll_evals"] if command == "evaluate" else res["nll_optims"]).all()


@pytest.mark.parametrize("key", ROUTE_KEYS, ids=["nll_fast_path=false", "nll_impl=xla"])
def test_route_key_evaluate_matches_jax_cli(tmp_path, key):
    res = rpe.evaluate(_cfg(tmp_path, "params/lotkavolterra2", LV, **key))
    assert res["route"] == "make_nll"
    ref = _jax_cli(tmp_path, "evaluate", "params/lotkavolterra2", {**LV, **key})
    np.testing.assert_array_equal(res["param_evals"], ref["param_evals"])
    np.testing.assert_allclose(res["nll_evals"], ref["nll_evals"], rtol=1e-9, atol=0.0)


def test_pendulum_evaluate_on_the_kernels_route_matches_jax_cli(tmp_path, make_nll_calls):
    res = rpe.evaluate(_cfg(tmp_path, "params/pendulum", PENDULUM, y_path=str(DATA / "pendulum.npz")))
    assert res["route"] == "nll_fwd kernel" and make_nll_calls == []
    assert res["nll_evals"].shape == (4, 25)
    ref = _jax_cli(tmp_path, "evaluate", "params/pendulum", PENDULUM)
    np.testing.assert_array_equal(res["param_evals"], ref["param_evals"])
    np.testing.assert_allclose(res["nll_evals"], ref["nll_evals"], rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("name", ["pendulum", "lorenz", "vanderpol"])
def test_npz_copies_equal_the_h5_traces(name):
    with h5py.File(REPO / "results" / "noise_gt" / f"{name}.h5", "r") as f:
        ref = {k: f[k][()] for k in f}
    with np.load(DATA / f"{name}.npz") as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(ref) == ["eps", "t", "x"]
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        assert got[k].tobytes() == ref[k].tobytes()
