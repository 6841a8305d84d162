"""The port's calibration sweep (``inference/calibrate.py``,
``run_calibration.py``) against the JAX package, and the committed ground
truth ``ode_uncertainty_tpu_torch/data/gt_lotkavolterra.npz``.

The configuration is calibration/rkf45/lotkavolterra (500 levels from 1e-16
to 1, H = I, no observation noise, P0 = 1e-12 I) cut to tN = 0.5 (50 steps,
an observation every step), float64.

Tolerances. The noise levels: rtol 1e-9; the argmin level: equal. The NLLs
are ill-conditioned where the noise level is small: with H = I and no
observation noise the correct pins the state to the observation, and the
NLL is set by the one-step residual y - x_pred, a difference of O(1)
numbers ~1e-9 apart, so one ulp of the state moves it by ~1e-7 of itself.
Each NLL is therefore held to the JAX package's within 10 times the change
that moving each observation by one ulp (up or down, signs from numpy seed
0) makes to the port's own NLL (measured in the test; its largest within 5
levels either side), plus rtol 1e-9; where the level dominates the residual (>= 1e-9), at rtol
1e-9 outright. The npz: bit for bit.
"""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.filters import SqrtEKF as JEKF
from ode_uncertainty_tpu.inference import make_calibration as j_make_calibration
from ode_uncertainty_tpu.inference import make_obs_model as j_make_obs_model
from ode_uncertainty_tpu.ops import const_diag as jcd
from ode_uncertainty_tpu_torch import run_calibration as rc
from ode_uncertainty_tpu_torch.utils.config import REPO, build_config, load_experiment
from test_torch_solution_cli import JaxScripts, _envelope, check_case, experiments

GT_H5 = REPO / "results" / "gt" / "lotkavolterra.h5"
GT_NPZ = REPO / "ode_uncertainty_tpu_torch" / "data" / "gt_lotkavolterra.npz"
EXPERIMENT = "calibration/rkf45/lotkavolterra"
TN = 0.5
CASES = [(e, e, {}) for e in experiments.all_experiments() if e.startswith("calibration/")]


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    scripts = JaxScripts(CASES, tmp_path_factory.mktemp("jax"))
    yield scripts
    scripts.close()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_run_calibration_matches_the_jax_script(case, jax_outputs, tmp_path):
    """Every calibration/* configuration through the port's run_calibration
    against scripts/run_calibration.py, 5 steps, all 500 levels, with the
    tolerances of tests/test_torch_solution_cli.py (the NLLs within their
    conditioning, as below)."""
    check_case(case, lambda: jax_outputs.output(CASES.index(case)), tmp_path)


def test_committed_ground_truth_equals_the_h5_rows():
    with h5py.File(GT_H5, "r") as h5, np.load(GT_NPZ) as npz:
        t, x = h5["t"][()], h5["x"][()]
        keep = t <= 20.0
        assert sorted(npz.files) == ["t", "x"]
        for key, ref in (("t", t[keep]), ("x", x[keep])):
            assert npz[key].dtype == ref.dtype and npz[key].shape == ref.shape
            np.testing.assert_array_equal(npz[key], ref)
    raw = load_experiment(EXPERIMENT)
    assert raw["tN"] <= 20.0  # the calibration grid reads no row past the cut


def _port(tmp_path, y_path, name, **overrides):
    cfg = build_config(load_experiment(EXPERIMENT), {
        "device": "cpu", "float64": True, "tN": TN, "y_path": str(y_path),
        "output": str(tmp_path / f"{name}.npz"), **overrides})
    return rc.run(cfg)


def test_run_calibration_gives_the_same_numbers_from_either_file(tmp_path):
    a = _port(tmp_path, GT_H5, "h5")
    b = _port(tmp_path, GT_NPZ, "npz")
    for key in ("noise_levels", "nll_conrad", "nll_ours"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["nll_conrad"].shape == (500,) and np.isfinite(a["nll_conrad"]).all()


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The port's sweep on the real ground truth, the same sweep with each
    observation moved by one ulp (the NLL's conditioning), and the JAX
    package's make_calibration on the same inputs."""
    tmp = tmp_path_factory.mktemp("cal")
    with np.load(GT_NPZ) as z:
        t, x = z["t"], z["x"]
    sign = np.random.default_rng(0).choice([-np.inf, np.inf], x.shape)
    np.savez(tmp / "ulp.npz", t=t, x=np.nextafter(x, sign))
    got = _port(tmp, GT_NPZ, "port")
    ulp = _port(tmp, tmp / "ulp.npz", "port_ulp")

    raw = load_experiment(EXPERIMENT)
    h = raw["solver_builder"]["init_args"]["step_size"]
    steps = int(np.ceil((TN - raw["t0"]) / h))
    jmod, jsol = jm.lotka_volterra(), js.rkf45(h)
    obs = j_make_obs_model(np.eye(2), t, x, raw["obs_noise_var"], raw["t0"], h, steps, dtype=jnp.float64)
    jekf = JEKF()
    state0 = jekf.init_state(raw["t0"], jnp.asarray([[1.0, 1.0]]), jcd(2, 1e-12, jnp.float64), 2)
    levels = jnp.logspace(raw["min_noise_log"], raw["max_noise_log"], raw["num_noise_levels"], dtype=jnp.float64)
    nll_static, nll_local = j_make_calibration(jekf, jsol, jmod, obs, state0, steps)(jmod.params, levels)
    ref = {"noise_levels": np.asarray(levels), "nll_conrad": np.asarray(nll_static), "nll_ours": np.asarray(nll_local)}
    return got, ulp, ref


@pytest.mark.parametrize("key", ["nll_conrad", "nll_ours"])
def test_make_calibration_matches_jax_within_its_conditioning(sweep, key):
    got, ulp, ref = sweep
    np.testing.assert_allclose(got["noise_levels"], ref["noise_levels"], rtol=1e-9)
    cond = _envelope(np.abs(ulp[key] - got[key]))
    gap = np.abs(got[key] - ref[key])
    assert np.all(gap <= 10.0 * cond + 1e-9 * np.abs(ref[key])), (gap / np.abs(ref[key])).max()
    if key == "nll_conrad":
        assert int(np.argmin(got[key])) == int(np.argmin(ref[key]))
        # where the level dominates the residual the sweep is well
        # conditioned, and the 1e-9 limit holds outright
        well = ref["noise_levels"] >= 1e-9
        np.testing.assert_allclose(got[key][well], ref[key][well], rtol=1e-9)


def test_static_sweep_is_one_batch_of_the_local_predict_shape(sweep):
    """The sweep varies with the level and the local-error NLL is finite;
    nan_to_num keeps a non-finite step from poisoning the mean."""
    got, _, _ = sweep
    assert np.ptp(got["nll_conrad"]) > 0 and np.isfinite(got["nll_ours"])
