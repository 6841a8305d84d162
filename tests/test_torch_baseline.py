"""The port's filter-free baseline (``make_baseline_nll`` in
``inference/nll.py`` and the ``run_parameter_estimation_baseline`` entry
point) against the JAX package's (``make_baseline_nll`` through
``scripts/run_parameter_estimation_baseline.py``'s ``_build_rig``), float64.

* The NLL and its gradient (autograd through the eager solve; JAX's
  ``jax.grad``) at rtol 1e-9 on params_baseline/lotkavolterra2 (RKF45,
  200 steps) and on params_baseline/hodgkinhuxley1_r4 across the stimulus
  onset (Kvaerno3 through the stage-solve rule, t0 = 9.9, 20 steps, the
  committed npz observations). The baseline starts step k at t0 + k h (the
  step index): step 10 starts at t = 10 exactly and meets the stimulus
  (t >= 10) at its first stage; moving t0 down by 1e-12 moves the onset
  to step 11 and changes the NLL by more than 1e-6, so the test tells the
  rules apart.
* The CLI: ``optimize`` (``num_random_runs=0``) and ``evaluate`` (a 4 x 3
  grid) on params_baseline/lotkavolterra2 at tN = 2 against the JAX
  script: keys equal, counters equal, optima and NLLs to 1e-9.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu.utils.config import instantiate as j_instantiate
from ode_uncertainty_tpu_torch.inference import make_baseline_nll
from ode_uncertainty_tpu_torch.inference.lbfgs import value_and_grad
from ode_uncertainty_tpu_torch.run_parameter_estimation_baseline import build_baseline
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment

REPO = Path(__file__).resolve().parent.parent
HH_NPZ = REPO / "ode_uncertainty_tpu_torch" / "data" / "hodgkinhuxley_r4.npz"
RTOL = 1e-9


def jax_baseline_module():
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location("jax_run_parameter_estimation_baseline",
                                                  REPO / "scripts" / "run_parameter_estimation_baseline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rigs(experiment, overrides):
    """(JAX (spec, nll [P] -> []), port (spec, nll [B, P] -> [B]), config)."""
    raw = {**load_experiment(experiment), **overrides, "float64": True}
    jcfg = {k: j_instantiate(v) for k, v in raw.items()}
    _, _, jspec, _, jnll, _ = jax_baseline_module()._build_rig(jcfg, jnp.float64)
    cfg = build_config(load_experiment(experiment), {**overrides, "float64": True, "device": "cpu"})
    return (jspec, jnll), build_baseline(cfg, torch.float64, torch.device("cpu")), cfg


def hh_overrides(t0=9.9, steps=20):
    return {"t0": t0, "tN": t0 + (steps - 0.5) * 0.01, "y_path": str(HH_NPZ)}


def check_value_and_grad(jax_rig, port_rig, points):
    _, jnll = jax_rig
    _, nll = port_rig
    ref_f = np.asarray(jax.vmap(jnll)(jnp.asarray(points)))
    ref_g = np.asarray(jax.vmap(jax.grad(jnll))(jnp.asarray(points)))
    f, g = value_and_grad(nll, torch.as_tensor(points))
    assert np.isfinite(ref_f).all() and np.isfinite(ref_g).all()
    np.testing.assert_allclose(f.numpy(), ref_f, rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=RTOL, atol=RTOL * np.abs(ref_g).max())
    return f.numpy()


def test_baseline_nll_matches_jax_on_lotka_volterra():
    jax_rig, port_rig, _ = rigs("params_baseline/lotkavolterra2", {"tN": 2.0})
    check_value_and_grad(jax_rig, port_rig, np.random.default_rng(3).uniform(0.1, 0.9, size=(6, 2)))


def test_baseline_nll_matches_jax_across_the_hodgkin_huxley_onset():
    jax_rig, port_rig, cfg = rigs("params_baseline/hodgkinhuxley1_r4", hh_overrides())
    h = cfg["solver_builder"].h
    assert 9.9 + 10 * h == 10.0  # step 10 starts at the onset by the step index
    points = np.array([[0.2], [0.31], [0.5], [0.8]])
    got = check_value_and_grad(jax_rig, port_rig, points)

    # the same solve with t0 just below: the onset moves to step 11
    spec, _ = port_rig
    model, solver = cfg["ode_builder"], cfg["solver_builder"]
    from ode_uncertainty_tpu_torch._common import build_x0, load_observations

    x0_raw, x0 = build_x0(cfg, model, torch.float64, "cpu")
    obs, _ = load_observations(cfg, solver, 20, x0.numel(), torch.float64, "cpu")
    moved = make_baseline_nll(model, solver, spec, obs, 9.9 - 1e-12, x0, 20)(torch.as_tensor(points)).detach()
    assert (np.abs(moved.numpy() - got) / np.abs(got)).max() > 1e-6


def _run(args, cwd, home, timeout=300):
    env = {"PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu", "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(home)}
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env, cwd=cwd, timeout=timeout)
    assert out.returncode == 0, f"{args} failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout


@pytest.mark.parametrize("command", ["optimize", "evaluate"])
def test_baseline_cli_matches_jax_script(tmp_path, command):
    port_out, jax_out = tmp_path / "port.h5", tmp_path / "jax.h5"
    common = [command, "--experiment", "params_baseline/lotkavolterra2", "--set", "tN=2.0", "--set", "float64=true",
              "--set", "num_random_runs=0", "--set", "lbfgs_maxiter=15",
              "--set", "num_param_evals={'alpha': 4, 'beta': 3, 'gamma': 1, 'delta': 1}"]
    _run(["-m", "ode_uncertainty_tpu_torch.run_parameter_estimation_baseline", *common, "--set", "device=cpu",
          "--set", f"output={port_out}"], cwd=tmp_path, home=tmp_path)
    _run(["run_parameter_estimation_baseline.py", *common, "--set", "platform=cpu", "--set", f"output={jax_out}"],
         cwd=REPO / "scripts", home=tmp_path)
    with h5py.File(port_out, "r") as got, h5py.File(jax_out, "r") as ref:
        assert sorted(got) == sorted(ref)
        for key in ref:
            a, b = got[key][()], ref[key][()]
            if key in ("wall_clock_s", "timings"):
                assert np.shape(a) == np.shape(b)
            elif np.asarray(b).dtype.kind in "iub" or key in ("params_name", "params_inits", "param_evals"):
                np.testing.assert_array_equal(a, b, err_msg=key)
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12, err_msg=key)
        if command == "optimize":
            assert got["num_lbfgs_iters"][0] > 2
        else:
            assert got["nll_evals"].shape == (1, 12)
