"""Parity of the PyTorch port's models, tableaus, ERK steps, ``solve`` and
``scan_save`` with the JAX package.

Inputs come from a numpy seed and go through both packages in float64.
Tolerance: rtol 1e-9 (atol 1e-12 where values cross zero): the same
arithmetic in the same order on both sides, so only last-bit rounding of
library kernels differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.utils.scan import scan_save as jax_scan_save
from ode_uncertainty_tpu_torch import models as tm
from ode_uncertainty_tpu_torch import solvers as ts
from ode_uncertainty_tpu_torch.utils.scan import scan_save as torch_scan_save

RTOL, ATOL = 1e-9, 1e-12

MODELS = [
    "exponential",
    "logistic",
    "lotka_volterra",
    "lorenz",
    "pendulum",
    "van_der_pol",
    "lcao",
    "rlc_circuit",
]
TABLEAUS = ["heun_euler", "bs32", "rkf45", "dopri65"]


@pytest.mark.parametrize("name", MODELS)
def test_rhs_matches_jax(name):
    jmod, tmod = getattr(jm, name)(), getattr(tm, name)()
    assert (tmod.name, tmod.n_order, tmod.dim) == (jmod.name, jmod.n_order, jmod.dim)
    assert sorted(tmod.params) == sorted(jmod.params)
    for k in tmod.params:
        assert float(tmod.params[k]) == float(jmod.params[k])
    y = np.random.default_rng(0).uniform(0.2, 1.5, (6, tmod.n_order, tmod.dim))
    ref = np.stack([np.asarray(jmod.rhs(jnp.asarray(0.3), jnp.asarray(yi), jmod.params)) for yi in y])
    got = tmod.rhs(0.3, torch.as_tensor(y), tmod.params).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_rhs_with_a_batch_of_parameters():
    # one parameter value per batch entry, as the NLL evaluates a grid
    jmod, tmod = jm.lotka_volterra(), tm.lotka_volterra()
    rng = np.random.default_rng(1)
    alphas, y = rng.uniform(0.5, 2.0, 7), rng.uniform(0.2, 1.5, (7, 1, 2))
    ref = jax.vmap(lambda a, yy: jmod.rhs(0.0, yy, {**jmod.params, "alpha": a}))(
        jnp.asarray(alphas), jnp.asarray(y)
    )
    got = tmod.rhs(0.0, torch.as_tensor(y), {**tmod.params, "alpha": torch.as_tensor(alphas)})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["exponential", "logistic", "rlc_circuit"])
def test_analytic_solution_matches_jax(name):
    jmod, tmod = getattr(jm, name)(), getattr(tm, name)()
    ts_np = np.linspace(0.0, 3.0, 11)
    x0 = np.full((tmod.n_order, tmod.dim), 0.7)
    ref = jmod.solution(jnp.asarray(ts_np), jnp.asarray(x0), jmod.params)
    got = tmod.solution(torch.as_tensor(ts_np), torch.as_tensor(x0), tmod.params)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", TABLEAUS)
def test_tableau_data_matches_jax(name):
    a, b = js.TABLEAUS[name], ts.TABLEAUS[name]
    assert (a.a, a.b_sol, a.b_err, a.c) == (b.a, b.b_sol, b.b_err, b.c)


@pytest.mark.parametrize("name", TABLEAUS)
def test_erk_step_matches_jax(name):
    jsol, tsol = getattr(js, name)(0.05), getattr(ts, name)(0.05)
    jmod, tmod = jm.lorenz(), tm.lorenz()
    x = np.random.default_rng(2).uniform(-1.0, 1.0, (5, 1, 3))
    for xi in x:
        ref_x, ref_eps = jsol.step(jmod.rhs, jmod.params, jnp.asarray(0.1), jnp.asarray(xi))
        got_x, got_eps = tsol.step(tmod.rhs, tmod.params, 0.1, torch.as_tensor(xi))
        np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_eps.numpy(), np.asarray(ref_eps), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("solver,save_every", [("rkf45", 1), ("dopri65", 10)])
def test_solve_matches_jax(solver, save_every):
    jsol, tsol = getattr(js, solver)(0.01), getattr(ts, solver)(0.01)
    x0 = np.array([[1.0, 1.0]])
    ref = js.solve(jsol, jm.lotka_volterra(), 0.0, jnp.asarray(x0), 400, save_every=save_every)
    got = ts.solve(tsol, tm.lotka_volterra(), 0.0, torch.as_tensor(x0), 400, save_every=save_every)
    for key in ("t", "x", "eps"):
        assert tuple(got[key].shape) == tuple(ref[key].shape)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=RTOL, atol=ATOL)


def test_scan_save_matches_jax():
    def jstep(s, idx):
        return (s[0] * 0.5 + idx, s[1] + 1.0)

    def tstep(s, idx):
        return (s[0] * 0.5 + idx, s[1] + 1.0)

    j_last, j_traj = jax_scan_save(jstep, (jnp.ones(3), jnp.zeros(())), 9, save_every=4)
    t_last, t_traj = torch_scan_save(tstep, (torch.ones(3, dtype=torch.float64), torch.zeros((), dtype=torch.float64)), 9, save_every=4)
    for got, ref in zip((*t_last, *t_traj), (*j_last, *j_traj)):
        assert tuple(got.shape) == tuple(ref.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
