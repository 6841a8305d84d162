"""The port's ``make_tempered_estimator`` (``inference/estimate.py``) with
both ``stage_scan`` values against the JAX package's (its host-looped
stages, ``stage_scan=False``, which its own tests hold equal to its
one-program sweep),
on the rig of tests/test_torch_estimate_device.py (params/lotkavolterra2 at
tN = 0.5, float64, 4 restarts), two stages: the experiment's first
tempering stage and gamma = 0. Tolerances as there; ``params_inits`` to
1e-15 relative (XLA fuses the affine map into a multiply-add); the port's
two stage modes equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu.inference import make_tempered_estimator as j_tempered
from ode_uncertainty_tpu_torch.inference import make_tempered_estimator
from test_torch_estimate_device import TOL, assert_close, rigs  # noqa: F401 (a fixture)

MAX_ITER = 3


@pytest.fixture(scope="module")
def runs(rigs):
    jspec, jnll, jq = rigs["jax"]
    spec, nll_b = rigs["port"]
    p0, gammas = rigs["p0"], rigs["gammas"]
    ref = j_tempered(jnll, jspec, jq, max_iter=MAX_ITER, tol=TOL, stage_scan=False)(jnp.asarray(p0),
                                                                                    jnp.asarray(gammas))
    got = {scan: make_tempered_estimator(nll_b, spec, max_iter=MAX_ITER, tol=TOL, stage_scan=scan)(
        torch.as_tensor(p0), torch.as_tensor(gammas)) for scan in (True, False)}
    return ref, got


@pytest.mark.parametrize("stage_scan", [True, False], ids=["stage_scan", "segments"])
def test_tempered_estimator_matches_jax(runs, stage_scan):
    ref, got = runs
    res = got[stage_scan]
    assert res.params_optims.shape == (4, 2, 2) and res.nll_optims.shape == (4, 2)
    as_dict = lambda r: {"x": np.asarray(r.params_optims), "f": np.asarray(r.nll_optims),
                         "iters": np.asarray(r.num_lbfgs_iters), "n_fev": np.asarray(r.num_nll_evals)}
    assert_close(as_dict(res), as_dict(ref))
    np.testing.assert_allclose(res.params_inits, np.asarray(ref.params_inits), rtol=1e-15)
    np.testing.assert_array_equal(res.gammas, np.asarray(ref.gammas))
    assert (res.num_lbfgs_iters > 0).all()
    # the two stage modes give the same values, bit for bit
    for field in res._fields:
        np.testing.assert_array_equal(getattr(res, field), getattr(got[not stage_scan], field), err_msg=field)
