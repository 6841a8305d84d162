"""The port's device stage optimizer (``inference/estimate.py``
``make_stage_optimizer``, what ``optimize --set optimizer_mode=device``
runs) against the JAX package's, on the params/lotkavolterra2 NLL cut to
tN = 0.5 (50 steps), float64, 4 restarts from one numpy array, the
experiment's first tempering stage. tests/test_torch_tempered_device.py
holds ``make_tempered_estimator`` on the same rig.

The port's objective is the entry points' route, the NLL kernels' wrapper
(their plain versions on the CPU, ``batched_nll``); JAX's is its XLA
``make_nll`` (the JAX CLI's ``_build_rig``). Tolerances as
tests/test_torch_lbfgs.py: ``x`` and ``f`` to 1e-10 (``f`` relative),
``g`` to 1e-8, the counters equal.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu.inference.estimate import make_stage_optimizer as j_stage_optimizer
from ode_uncertainty_tpu.utils.config import instantiate as j_instantiate
from ode_uncertainty_tpu_torch import run_parameter_estimation as rpe
from ode_uncertainty_tpu_torch.inference.estimate import make_stage_optimizer
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment

REPO = Path(__file__).resolve().parent.parent
MAX_ITER, TOL = 5, 1e-6
OVERRIDES = {"tN": 0.5, "float64": True, "device": "cpu"}


def jax_cli_module():
    """scripts/run_parameter_estimation.py, imported under its own name."""
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location("jax_run_parameter_estimation",
                                                  REPO / "scripts" / "run_parameter_estimation.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def rigs():
    raw = {**load_experiment("params/lotkavolterra2"), **OVERRIDES}
    jcfg = {k: j_instantiate(v) for k, v in raw.items()}
    _, _, jspec, _, _, _, jnll, jq, _ = jax_cli_module()._build_rig(jcfg, jnp.float64)
    cfg = build_config(load_experiment("params/lotkavolterra2"), OVERRIDES)
    rig = rpe.build_rig(cfg, torch.float64, torch.device("cpu"))
    nll_b, on_kernels = rpe.batched_nll(rig, cfg, grad=True)
    assert on_kernels
    p0 = np.random.default_rng(11).uniform(0.1, 0.9, size=(4, 2))
    gammas = np.asarray(rpe.gammas_of(cfg, torch.float64)[[0, -1]])
    assert gammas[-1] == 0.0 and gammas[0] > 0.0
    return {"jax": (jspec, jnll, jq), "port": (rig.spec, nll_b), "p0": p0, "gammas": gammas}


def assert_close(got: dict, ref: dict) -> None:
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=1e-10, err_msg="x")
    np.testing.assert_allclose(got["f"], ref["f"], rtol=1e-10, err_msg="f")
    if "g" in ref:
        np.testing.assert_allclose(got["g"], ref["g"], rtol=0, atol=1e-8, err_msg="g")
    for field in ("iters", "n_fev"):
        np.testing.assert_array_equal(got[field], ref[field], err_msg=field)


def test_stage_optimizer_matches_jax(rigs):
    _, jnll, jq = rigs["jax"]
    gamma = rigs["gammas"][0]
    ref = j_stage_optimizer(jnll, jq, max_iter=MAX_ITER, tol=TOL)(jnp.asarray(rigs["p0"]), jnp.asarray(gamma))
    widths = []

    def counted(p, gamma_sqrt):
        widths.append(p.shape[0])
        return rigs["port"][1](p, gamma_sqrt)

    got = make_stage_optimizer(counted, max_iter=MAX_ITER, tol=TOL)(torch.as_tensor(rigs["p0"]),
                                                                    torch.as_tensor(gamma))
    assert_close({f: getattr(got, f).numpy() for f in got._fields},
                 {f: np.asarray(getattr(ref, f)) for f in ref._fields})
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert sum(widths) == int(got.n_fev.sum()) and got.iters.max() > 1
