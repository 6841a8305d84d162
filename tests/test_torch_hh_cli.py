"""The port's ``evaluate`` on params/hodgkinhuxley1_r4 (Kvaerno3, the
kernel's route: its plain version on the CPU) against the JAX CLI, the
committed npz copies of the Hodgkin-Huxley observation files, and
``optimize`` on Kvaerno3 experiments: it runs on the kernels' route for
the single-compartment variants (reduced-4, reduced-1 and full: their
gradient units are instantiated), and through ``make_nll`` + autograd
(the stage-solve rule at second order) where no kernel covers the
configuration: multi-compartment HH (params/hodgkinhuxley2_c2_r4, n = 8;
params/hodgkinhuxley6_c2_r1, n = 14) and ``initial_state_parametrized``
(HH full), at one step, one stage and one L-BFGS iteration (the eager
route costs a few seconds a step on the CPU).

Both CLIs run float64 at a cut horizon (``tN=0.3``, 30 steps, before the
stimulus starts at t = 10, so the two routes' time rules agree) on the
shipped H5 file; the NLL landscape agrees at rtol 1e-9, the grid exactly,
the tempering schedule to rtol 1e-15 (the JAX CLI computes it with
``jnp.power``, the port with ``np.power``).
"""

import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from ode_uncertainty_tpu_torch import run_parameter_estimation as rpe
from ode_uncertainty_tpu_torch.ops import nll_kernel
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "ode_uncertainty_tpu_torch" / "data"


def _run(args, cwd, home, timeout=600):
    env = {
        "PYTHONPATH": str(REPO),
        "JAX_PLATFORMS": "cpu",
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "HOME": str(home),
    }
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                         cwd=cwd, timeout=timeout)
    assert out.returncode == 0, f"{args} failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout


def test_hh_evaluate_cli_matches_jax_cli(tmp_path):
    port_out, jax_out = tmp_path / "port.h5", tmp_path / "jax.h5"
    common = ["evaluate", "--experiment", "params/hodgkinhuxley1_r4", "--set", "tN=0.3",
              "--set", "float64=true"]
    stdout = _run(["-m", "ode_uncertainty_tpu_torch.run_parameter_estimation", *common,
                   "--set", "device=cpu", "--set", f"output={port_out}"], cwd=tmp_path, home=tmp_path)
    assert "nll_fwd kernel" in stdout  # the kernel's route (its plain version on the CPU)
    _run(["run_parameter_estimation.py", *common, "--set", "platform=cpu",
          "--set", f"output={jax_out}"], cwd=REPO / "scripts", home=tmp_path)
    with h5py.File(port_out, "r") as got, h5py.File(jax_out, "r") as ref:
        assert sorted(got) == sorted(ref) == ["gammas", "nll_evals", "param_evals", "timings"]
        np.testing.assert_array_equal(got["param_evals"][()], ref["param_evals"][()])
        np.testing.assert_allclose(got["gammas"][()], ref["gammas"][()], rtol=1e-15, atol=0.0)
        assert got["timings"].shape == ref["timings"].shape
        assert got["nll_evals"].shape == (4, 100)
        np.testing.assert_allclose(got["nll_evals"][()], ref["nll_evals"][()], rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("name", ["hodgkinhuxley_r4", "hodgkinhuxley_r1", "hodgkinhuxley_full",
                                  "hodgkinhuxley_c2_r4", "hodgkinhuxley_c2_r1"])
def test_npz_copies_equal_the_observation_files(name):
    with h5py.File(REPO / "results" / "noise_gt" / f"{name}.h5", "r") as ref, \
            np.load(DATA / f"{name}.npz", allow_pickle=False) as got:
        assert sorted(got.files) == ["t", "x"]
        for key in ("t", "x"):
            assert got[key].dtype == ref[key].dtype == np.float32
            assert got[key].shape[0] == 10001
            np.testing.assert_array_equal(got[key], ref[key][()])
            assert got[key].tobytes() == ref[key][()].tobytes()  # bit for bit, NaN rows too


def test_hh_evaluate_reads_the_npz_copy(tmp_path):
    cfg = build_config(load_experiment("params/hodgkinhuxley1_r4"),
                       {"device": "cpu", "tN": 0.05, "y_path": str(DATA / "hodgkinhuxley_r4.npz"),
                        "num_param_evals": {"g_Na": 3}, "output": str(tmp_path / "out.npz")})
    res = rpe.evaluate(cfg)
    h5_cfg = build_config(load_experiment("params/hodgkinhuxley1_r4"),
                          {"device": "cpu", "tN": 0.05, "num_param_evals": {"g_Na": 3},
                           "output": str(tmp_path / "h5.npz")})
    ref = rpe.evaluate(h5_cfg)
    assert res["route"] == "nll_fwd kernel" and res["nll_evals"].shape == (4, 3)
    np.testing.assert_array_equal(res["nll_evals"], ref["nll_evals"])


def _no_make_nll(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("optimize on Kvaerno3 reached make_nll + autograd")

    monkeypatch.setattr(rpe, "make_nll", refuse)


def _optimize_through_make_nll(tmp_path, monkeypatch, experiment, data, **overrides):
    """optimize at one step, one restart, one stage and one iteration with
    the kernels refused; returns the result and make_nll's keyword
    arguments."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("optimize took the kernels' route")

    monkeypatch.setattr(rpe, "make_nll_cuda", no_kernel)
    calls = []
    real = rpe.make_nll

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(rpe, "make_nll", spy)
    cfg = build_config(load_experiment(experiment),
                       {"device": "cpu", "tN": 0.01, "num_random_runs": 0, "num_tempering_stages": 1,
                        "lbfgs_maxiter": 1, "y_path": str(DATA / data), "output": str(tmp_path / "out.npz"),
                        **overrides})
    res = rpe.optimize(cfg)
    assert res["route"] == "make_nll + autograd" and len(calls) == 1
    n_opt = sum(int(np.prod(np.shape(cfg["ode_builder"].params[k])) or 1)
                for k, on in cfg["params_optimized"].items() if on)
    assert res["params_optims"].shape == (1, 1, n_opt)
    assert np.isfinite(res["nll_optims"]).all() and np.isfinite(res["params_optims"]).all()
    assert (tmp_path / "out.npz").exists()
    return res, calls[0]


def test_optimize_on_kvaerno3_raises(tmp_path, monkeypatch):
    # HH full with initial_state_parametrized: each lane's initial state
    # comes from its parameters, which the kernels do not compute, so the
    # route is make_nll + autograd
    _, kw = _optimize_through_make_nll(tmp_path, monkeypatch, "params/hodgkinhuxley7_full",
                                       "hodgkinhuxley_full.npz", initial_state_parametrized=True)
    assert kw["initial_state_parametrized"] is True


@pytest.mark.parametrize("experiment", ["params/hodgkinhuxley2_c2_r4", "params/hodgkinhuxley6_c2_r1"])
def test_optimize_on_kvaerno3_without_a_gradient_unit_raises(tmp_path, monkeypatch, experiment):
    # multi-compartment HH (n = 8 and n = 14, per-compartment parameters):
    # no kernel covers it, so the route is make_nll + autograd
    data = {"params/hodgkinhuxley2_c2_r4": "hodgkinhuxley_c2_r4.npz",
            "params/hodgkinhuxley6_c2_r1": "hodgkinhuxley_c2_r1.npz"}[experiment]
    res, kw = _optimize_through_make_nll(tmp_path, monkeypatch, experiment, data)
    assert kw["initial_state_parametrized"] is False
    assert res["params_optims"].shape[-1] == {"params/hodgkinhuxley2_c2_r4": 4, "params/hodgkinhuxley6_c2_r1": 12}[experiment]


def _optimize_on_the_kernels_route(tmp_path, monkeypatch, experiment, data):
    """optimize at a cut depth (tN 0.05, 2 restarts, 2 stages, 2 iterations)
    with make_nll refused; returns the result, the config and the (model,
    solver, rows) of every gradient the wrapper was asked for."""
    _no_make_nll(monkeypatch)
    cfg = build_config(load_experiment(experiment),
                       {"device": "cpu", "tN": 0.05, "num_random_runs": 2, "num_tempering_stages": 2,
                        "lbfgs_maxiter": 2, "y_path": str(DATA / data), "output": str(tmp_path / "out.npz")})
    seen = []
    grad = nll_kernel.NllGrad.__call__

    def spy(self, phys_t, gamma_sqrt, g, with_dgamma=True, rows=None):
        seen.append((self.cm.model_name, self.cm.solver.name, rows))
        return grad(self, phys_t, gamma_sqrt, g, with_dgamma, rows)

    monkeypatch.setattr(nll_kernel.NllGrad, "__call__", spy)
    res = rpe.optimize(cfg)
    assert res["route"] == "nll_fwd + nll_bwd kernels"
    assert np.isfinite(res["nll_optims"]).all()
    return res, cfg, seen


def test_optimize_on_kvaerno3_r4_takes_the_kernels_route(tmp_path, monkeypatch):
    res, cfg, seen = _optimize_on_the_kernels_route(tmp_path, monkeypatch, "params/hodgkinhuxley1_r4",
                                                    "hodgkinhuxley_r4.npz")
    assert res["params_optims"].shape == (2, 2, 1)
    # every gradient went through the Kvaerno3 gradient wrapper, for the
    # optimized row alone (the parameter rows follow the sorted names)
    row = sorted(cfg["ode_builder"].params).index("g_Na")
    assert seen and set(seen) == {("hodgkin_huxley_reduced-4", "kvaerno3", (row,))}


@pytest.mark.parametrize("experiment,data,variant", [
    ("params/hodgkinhuxley7_full", "hodgkinhuxley_full.npz", "full"),
    ("params/hodgkinhuxley6_r1", "hodgkinhuxley_r1.npz", "reduced-1"),
])
def test_optimize_on_kvaerno3_full_and_r1_take_the_kernels_route(tmp_path, monkeypatch, experiment, data, variant):
    # the n = 8 and n = 7 gradient units: every gradient on the optimized
    # rows alone (7 for hodgkinhuxley7_full, 6 for hodgkinhuxley6_r1)
    res, cfg, seen = _optimize_on_the_kernels_route(tmp_path, monkeypatch, experiment, data)
    names = sorted(cfg["ode_builder"].params)
    rows = tuple(sorted(names.index(k) for k, on in cfg["params_optimized"].items() if on))
    assert len(rows) == {"full": 7, "reduced-1": 6}[variant]
    assert res["params_optims"].shape == (2, 2, len(rows))
    assert seen and set(seen) == {(f"hodgkin_huxley_{variant}", "kvaerno3", rows)}
