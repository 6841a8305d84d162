"""Parity of the PyTorch port's covariance updates and square-root EKF
predict/correct with the JAX package.

Inputs come from a numpy seed; the port runs a batch of states at once, the
JAX package the same states one by one. Tolerance: float64 rtol 1e-9 (atol
1e-12 where values cross zero) on values and on the covariance P P^T (the
sqrt factor's column signs are a convention both share, so P itself is
compared too).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.filters import cov_updates as jcu
from ode_uncertainty_tpu.filters.sqrt_ekf import SqrtEKF as JEKF
from ode_uncertainty_tpu_torch import models as tm
from ode_uncertainty_tpu_torch import solvers as ts
from ode_uncertainty_tpu_torch.filters import cov_updates as tcu
from ode_uncertainty_tpu_torch.filters.sqrt_ekf import SqrtEKF as TEKF

F64 = dict(rtol=1e-9, atol=1e-12)
B = 5


def _states(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.5, 1.5, (B, 1, 2))
    a = rng.standard_normal((B, 2, 2)) * 0.1
    p = np.linalg.cholesky(a @ np.swapaxes(a, -1, -2) + 1e-3 * np.eye(2))
    return x, p


@pytest.mark.parametrize("name", ["DiagonalCovarianceUpdate", "OuterCovarianceUpdate"])
def test_cov_update_apply_sqrt_matches_jax(name):
    x, p = _states(1)
    eps = np.abs(x.reshape(B, 2)) * 1e-3
    eps[0] = 0.0  # exact steps: the outer update's zero guard
    ju, tu = jcu.COV_UPDATE_REGISTRY[name](scale=2.0), tcu.COV_UPDATE_REGISTRY[name](scale=2.0)
    got = tu.apply_sqrt(torch.as_tensor(p), torch.as_tensor(eps)).numpy()
    for i in range(B):
        ref = ju.apply_sqrt(jnp.asarray(p[i]), jnp.asarray(eps[i]))
        np.testing.assert_allclose(got[i], np.asarray(ref), **F64)
        cov = tu.apply(torch.as_tensor(p[i] @ p[i].T), torch.as_tensor(eps[i])).numpy()
        np.testing.assert_allclose(cov, np.asarray(ju.apply(jnp.asarray(p[i] @ p[i].T), jnp.asarray(eps[i]))), **F64)


@pytest.mark.parametrize(
    "gamma,disable", [(0.1, True), (0.0, True), (0.1, False), (0.0, False)]
)
def test_predict_matches_jax(gamma, disable):
    x, p = _states(2)
    jmod, tmod = jm.lotka_volterra(), tm.lotka_volterra()
    jpred = JEKF(disable_cov_update=disable).make_predict(js.rkf45(0.05), jmod.rhs)
    tekf = TEKF(disable_cov_update=disable)
    tpred = tekf.make_predict(ts.rkf45(0.05), tmod.rhs)
    q = np.diag([1.0, 0.5])
    s = tekf.init_state(0.0, torch.as_tensor(x), torch.as_tensor(p), 1)
    got = tpred(s, tmod.params, torch.as_tensor(q), torch.tensor(gamma ** 0.5, dtype=torch.float64))
    for i in range(B):
        js0 = JEKF(disable_cov_update=disable).init_state(0.0, jnp.asarray(x[i]), jnp.asarray(p[i]), 1)
        ref = jpred(js0, jmod.params, jnp.asarray(q), jnp.asarray(gamma ** 0.5))
        np.testing.assert_allclose(got.x[i].numpy(), np.asarray(ref.x), **F64)
        np.testing.assert_allclose(got.eps[i].numpy(), np.asarray(ref.eps), **F64)
        np.testing.assert_allclose(got.P_sqrt[i].numpy(), np.asarray(ref.P_sqrt), **F64)
        np.testing.assert_allclose(float(got.t), float(ref.t), **F64)


@pytest.mark.parametrize("obs_rows", [[[1.0, 0.0]], [[1.0, 0.0], [0.0, 1.0]]])
def test_correct_matches_jax(obs_rows):
    x, p = _states(3)
    h_mat = np.asarray(obs_rows)
    L = h_mat.shape[0]
    r = np.sqrt(0.1) * np.eye(L)
    y = np.random.default_rng(4).uniform(0.5, 1.5, L)
    jcorr, tekf = JEKF().make_correct(), TEKF()
    s = tekf.init_state(0.0, torch.as_tensor(x), torch.as_tensor(p), L)
    got = tekf.make_correct()(s, torch.as_tensor(h_mat), torch.as_tensor(y), torch.as_tensor(r))
    for i in range(B):
        js0 = JEKF().init_state(0.0, jnp.asarray(x[i]), jnp.asarray(p[i]), L)
        ref = jcorr(js0, jnp.asarray(h_mat), jnp.asarray(y), jnp.asarray(r))
        for f in ("x", "P_sqrt", "y_hat", "S_sqrt"):
            np.testing.assert_allclose(getattr(got, f)[i].numpy(), np.asarray(getattr(ref, f)), **F64)


def test_correct_zero_gain_guard():
    # an all-zero innovation sqrt (no prior and no observation noise) must
    # leave the state alone instead of dividing by zero
    tekf = TEKF()
    x = torch.tensor([[[1.0, 2.0]]], dtype=torch.float64)
    s = tekf.init_state(0.0, x, torch.zeros(1, 2, 2, dtype=torch.float64), 1)
    out = tekf.make_correct()(s, torch.tensor([[1.0, 0.0]], dtype=torch.float64),
                              torch.tensor([5.0], dtype=torch.float64), torch.zeros(1, 1, dtype=torch.float64))
    np.testing.assert_array_equal(out.x.numpy(), x.numpy())
    assert np.isfinite(out.P_sqrt.numpy()).all()
