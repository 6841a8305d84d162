"""The port's trajectory RMSE (``inference/trmse.py`` and the
``compute_trmse`` entry point) against the JAX package's
(``make_trmse_evaluator``, ``scripts/compute_trmse.py``), float64, on
params/lotkavolterra2 cut to tN = 2 (200 RKF45 steps).

The estimates are 5 rows near the generating parameters and one row whose
alpha (1e4, outside the box) makes the RKF45 steps of 0.01 blow up:
its tRMSE is non-finite on both sides, and the mean and std are over the
finite rows. Values and the summary at rtol 1e-9, the non-finite positions
equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import h5py
import jax.numpy as jnp
import numpy as np
import torch

from ode_uncertainty_tpu.inference import make_param_spec as j_make_param_spec
from ode_uncertainty_tpu.inference import make_trmse_evaluator as j_make_trmse_evaluator
from ode_uncertainty_tpu.utils.config import instantiate as j_instantiate
from ode_uncertainty_tpu.utils.config import parse_literal
from ode_uncertainty_tpu_torch.inference import make_param_spec, make_trmse_evaluator, trmse
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment

REPO = Path(__file__).resolve().parent.parent
EXPERIMENT = "params/lotkavolterra2"
TN = 2.0
RTOL = 1e-9


def estimates():
    rows = np.array([1.5, 1.0]) * (1.0 + np.random.default_rng(5).uniform(-0.2, 0.2, size=(5, 2)))
    return np.concatenate([rows, [[1.0e4, 1.0]]])


def assert_same(got, ref) -> None:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL)


def test_trmse_evaluator_matches_jax_with_a_diverging_row():
    raw = {**load_experiment(EXPERIMENT), "tN": TN}
    jcfg = {k: j_instantiate(v) for k, v in raw.items()}
    cfg = build_config(load_experiment(EXPERIMENT), {"tN": TN})
    steps = 200
    jm, js = jcfg["ode_builder"], jcfg["solver_builder"]
    x0 = parse_literal(raw["x0"])
    jspec = j_make_param_spec(jm.params, raw["params_range"], raw["params_optimized"], dtype=jnp.float64)
    ref = j_make_trmse_evaluator(jm, js, jspec, raw["t0"], jnp.asarray(x0, jnp.float64), steps)(
        jnp.asarray(estimates()))
    model, solver = cfg["ode_builder"], cfg["solver_builder"]
    spec = make_param_spec(model.params, raw["params_range"], raw["params_optimized"], dtype=torch.float64,
                           device="cpu")
    got = make_trmse_evaluator(model, solver, spec, raw["t0"], torch.tensor(x0, dtype=torch.float64), steps)(
        torch.as_tensor(estimates()))
    vals = got[0].numpy()
    assert vals.shape == (6,) and not np.isfinite(vals[-1]) and np.isfinite(vals[:-1]).all()
    for g, r in zip(got, ref):
        assert_same(g.numpy(), r)
    # the NaN-robust summary: mean and std of the finite rows
    np.testing.assert_allclose(got[1].item(), vals[:-1].mean(), rtol=1e-12)
    np.testing.assert_allclose(got[2].item(), vals[:-1].std(ddof=1), rtol=1e-12)


def test_trmse_of_one_trajectory_and_of_a_batch():
    rng = np.random.default_rng(0)
    true, est = rng.standard_normal((7, 1, 2)), rng.standard_normal((7, 3, 1, 2))
    batched = trmse(torch.as_tensor(true), torch.as_tensor(est)).numpy()
    one = [trmse(torch.as_tensor(true), torch.as_tensor(est[:, r])).item() for r in range(3)]
    expect = [np.sqrt(np.mean(np.sum((est[:, r] - true).reshape(7, -1) ** 2, axis=-1))) for r in range(3)]
    np.testing.assert_allclose(batched, expect, rtol=1e-14)
    np.testing.assert_allclose(one, expect, rtol=1e-14)


def _run(args, cwd, home, timeout=300):
    env = {"PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu", "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(home)}
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env, cwd=cwd, timeout=timeout)
    assert out.returncode == 0, f"{args} failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout


def test_compute_trmse_cli_matches_jax_script(tmp_path):
    # an estimation output with 3 stages: the entry points read the last one
    params_optims = np.stack([estimates() * 1.1, estimates() * 0.9, estimates()], axis=1)
    files = {}
    for side in ("port", "jax"):
        files[side] = tmp_path / f"{side}.h5"
        with h5py.File(files[side], "w") as f:
            f["params_optims"] = params_optims
    common = ["--experiment", EXPERIMENT, "--set", f"tN={TN}", "--set", "float64=true"]
    stdout = _run(["-m", "ode_uncertainty_tpu_torch.compute_trmse", *common, "--set", "device=cpu",
                   "--set", f"parameter_estimates_input={files['port']}"], cwd=tmp_path, home=tmp_path)
    assert "5/6 runs finite" in stdout
    _run(["compute_trmse.py", *common, "--set", "platform=cpu", "--set", f"parameter_estimates_input={files['jax']}"],
         cwd=REPO / "scripts", home=tmp_path)
    with h5py.File(files["port"], "r") as got, h5py.File(files["jax"], "r") as ref:
        assert sorted(got) == sorted(ref) == ["params_optims", "trmse_mean", "trmse_std", "trmse_values"]
        for key in ("trmse_values", "trmse_mean", "trmse_std"):
            assert got[key].dtype == ref[key].dtype == np.float64
            assert_same(got[key][()], ref[key][()])
