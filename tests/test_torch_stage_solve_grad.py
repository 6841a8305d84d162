"""Reverse mode through the port's Kvaerno3 stage solve (``StageSolve``'s
``backward`` and the reverse-mode derivative of its ``jvp`` rule) against the
JAX package's ``custom_jvp``, and ``pull_sqrt`` / ``value_and_jacfwd``
against JAX's.

* First order: the VJP of one ``Kvaerno3.step`` (x_next and eps) in the
  state and in the per-lane parameters g_Na and g_K, against ``jax.vjp``.
* Second order: the Jacobian in the parameters of ``push_sqrt``'s columns
  (J_step @ S for a fixed S), against ``jax.jacrev`` over JAX's
  ``push_sqrt``: reverse mode through the rule's tangents, with the stage
  solution itself differentiated by the rule.

Hodgkin-Huxley reduced-4 (n = 4) and the two-compartment model of
params/hodgkinhuxley2_c2_r4 (n = 8, per-compartment parameters), one step
from t = 9.995 across the stimulus onset at t = 10, two lanes near the rest
state with their own parameters; each lane is held to JAX's single-lane
result. Tolerance: float64 rtol 1e-9 (x64 from tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.ops.linearize import pull_sqrt as j_pull
from ode_uncertainty_tpu.ops.linearize import push_sqrt as j_push
from ode_uncertainty_tpu.ops.linearize import value_and_jacfwd as j_jacfwd
from ode_uncertainty_tpu_torch import models as tm
from ode_uncertainty_tpu_torch import solvers as ts
from ode_uncertainty_tpu_torch.ops.linearize import pull_sqrt as t_pull
from ode_uncertainty_tpu_torch.ops.linearize import push_sqrt as t_push
from ode_uncertainty_tpu_torch.ops.linearize import value_and_jacfwd as t_jacfwd
from ode_uncertainty_tpu_torch.utils.config import load_experiment

TOL = dict(rtol=1e-9, atol=0.0)
KEYS = ("g_Na", "g_K")
T_ONSET = 9.995  # the step's stages cross t = 10
LANES = 2


def hh_models(name):
    """(JAX model, port model, x0 [1, n] at rest)."""
    if name == "c2_r4":
        init = load_experiment("params/hodgkinhuxley2_c2_r4")["ode_builder"]["init_args"]
        jmod, tmod = jm.multi_compartment_hodgkin_huxley(**init), tm.multi_compartment_hodgkin_huxley(**init)
        v0 = jnp.array([[-70.0, -70.0]])
    else:
        jmod, tmod = jm.hodgkin_huxley(name), tm.hodgkin_huxley(name)
        v0 = jnp.array([[-70.0]])
    return jmod, tmod, np.asarray(jmod.build_initial_value(v0, jmod.params), np.float64)


def lanes(jmod, x0, seed=0):
    """Per-lane states (rest plus a small perturbation) [LANES, n] and
    parameters {key: [LANES, *shape]} (defaults times 1 +- 10%)."""
    rng = np.random.default_rng(seed)
    xs = x0.reshape(1, -1) + 0.01 * rng.standard_normal((LANES, x0.size))
    ps = {k: np.asarray(jmod.params[k], np.float64) * (1.0 + 0.1 * rng.uniform(-1, 1, (LANES, *np.shape(jmod.params[k]))))
          for k in KEYS}
    return xs, ps


def jax_step(jmod, sol, shape):
    def step(x, pv):
        xn, e = sol.step(jmod.rhs, {**jmod.params, **pv}, jnp.asarray(T_ONSET), x.reshape(shape))
        return xn.reshape(-1), e.reshape(-1)

    return step


def port_step(tmod, sol, shape):
    def step(x, pv):
        p = {**tmod.params, **pv}
        xn, e = sol.step(tmod.rhs, p, torch.tensor(T_ONSET, dtype=torch.float64), x.reshape(*x.shape[:-1], *shape))
        return xn.reshape(x.shape), e.reshape(x.shape)

    return step


@pytest.mark.parametrize("name", ["reduced-4", "c2_r4"])
def test_step_vjp_matches_jax(name):
    jmod, tmod, x0 = hh_models(name)
    xs, ps = lanes(jmod, x0)
    rng = np.random.default_rng(1)
    cx, ce = rng.standard_normal(xs.shape), rng.standard_normal(xs.shape)

    x_t = torch.tensor(xs, requires_grad=True)
    p_t = {k: torch.tensor(v, requires_grad=True) for k, v in ps.items()}
    xn, e = port_step(tmod, ts.kvaerno3(0.01), x0.shape)(x_t, p_t)
    loss = (xn * torch.as_tensor(cx)).sum() + (e * torch.as_tensor(ce)).sum()
    got = torch.autograd.grad(loss, [x_t, *p_t.values()])

    step = jax_step(jmod, js.kvaerno3(0.01), x0.shape)
    for lane in range(LANES):
        (jxn, je), vjp = jax.vjp(step, jnp.asarray(xs[lane]), {k: jnp.asarray(v[lane]) for k, v in ps.items()})
        np.testing.assert_allclose(xn[lane].detach().numpy(), np.asarray(jxn), **TOL)
        gx, gp = vjp((jnp.asarray(cx[lane]), jnp.asarray(ce[lane])))
        assert np.abs(np.asarray(gx)).min() > 0.0
        np.testing.assert_allclose(got[0][lane].numpy(), np.asarray(gx), **TOL)
        for i, k in enumerate(KEYS):
            np.testing.assert_allclose(got[1 + i][lane].numpy(), np.asarray(gp[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("name", ["reduced-4", "c2_r4"])
def test_push_sqrt_parameter_jacobian_matches_jax(name):
    jmod, tmod, x0 = hh_models(name)
    xs, ps = lanes(jmod, x0, seed=2)
    n = x0.size
    s_mat = np.linalg.qr(np.random.default_rng(3).standard_normal((n, n)))[0]

    # one port lane per (lane, i, j) with its own copy of the lane's
    # parameters: one backward pass of sum_b cols[b, i_b, j_b] gives every
    # entry of the Jacobian (the lanes are independent)
    copies = n * n
    p_t = {k: torch.tensor(np.repeat(v, copies, axis=0), requires_grad=True) for k, v in ps.items()}
    step_t = port_step(tmod, ts.kvaerno3(0.01), x0.shape)
    _, cols = t_push(lambda x: step_t(x, p_t), torch.tensor(np.repeat(xs, copies, axis=0)), torch.tensor(s_mat))
    ij = torch.arange(LANES * copies) % copies
    picked = cols[torch.arange(LANES * copies), ij // n, ij % n]
    grads = torch.autograd.grad(picked.sum(), list(p_t.values()))
    got = {k: g.reshape(LANES, n, n, *np.shape(jmod.params[k])).numpy() for k, g in zip(KEYS, grads)}

    step_j = jax_step(jmod, js.kvaerno3(0.01), x0.shape)

    def cols_j(pv, x):
        return j_push(lambda z: step_j(z, pv), x, jnp.asarray(s_mat))[1]

    jac_j = jax.jit(jax.jacrev(cols_j))
    for lane in range(LANES):
        pv = {k: jnp.asarray(v[lane]) for k, v in ps.items()}
        x_l = jnp.asarray(xs[lane])
        np.testing.assert_allclose(cols[lane * copies].detach().numpy(), np.asarray(cols_j(pv, x_l)), **TOL)
        ref = jac_j(pv, x_l)
        for k in KEYS:
            assert np.abs(np.asarray(ref[k])).max() > 0.0
            np.testing.assert_allclose(got[k][lane], np.asarray(ref[k]), **TOL, err_msg=k)


def _rigs(name):
    """(JAX step, port step, states [LANES, n]) of an LV RKF45 step or an HH
    reduced-4 Kvaerno3 step at the models' defaults."""
    if name == "lv":
        jmod, tmod = jm.lotka_volterra(), tm.lotka_volterra()
        jsol, tsol, shape = js.rkf45(0.01), ts.rkf45(0.01), (1, 2)
        xs = np.array([[1.0, 1.0], [0.7, 1.4]])
    else:
        jmod, tmod, x0 = hh_models("reduced-4")
        jsol, tsol, shape = js.kvaerno3(0.01), ts.kvaerno3(0.01), x0.shape
        xs = lanes(jmod, x0)[0]
    j_fn = lambda x: jax_step(jmod, jsol, shape)(x, {})
    return j_fn, (lambda x: port_step(tmod, tsol, shape)(x, {})), xs


@pytest.mark.parametrize("name", ["lv", "hh"])
def test_pull_sqrt_matches_jax(name):
    j_fn, t_fn, xs = _rigs(name)
    m_rows = np.random.default_rng(4).standard_normal((3, xs.shape[1]))
    (out, aux), rows = t_pull(t_fn, torch.tensor(xs), torch.tensor(m_rows))
    assert rows.shape == (LANES, 3, xs.shape[1])
    for lane in range(LANES):
        (j_out, j_aux), j_rows = j_pull(j_fn, jnp.asarray(xs[lane]), jnp.asarray(m_rows))
        np.testing.assert_allclose(out[lane].numpy(), np.asarray(j_out), **TOL)
        np.testing.assert_allclose(aux[lane].numpy(), np.asarray(j_aux), **TOL)
        np.testing.assert_allclose(rows[lane].numpy(), np.asarray(j_rows), **TOL)


@pytest.mark.parametrize("name", ["lv", "hh"])
def test_value_and_jacfwd_matches_jax(name):
    j_fn, t_fn, xs = _rigs(name)
    out, jac = t_jacfwd(lambda x: t_fn(x)[0], torch.tensor(xs))
    assert jac.shape == (LANES, xs.shape[1], xs.shape[1])
    for lane in range(LANES):
        j_out, j_jac = j_jacfwd(lambda x: j_fn(x)[0], jnp.asarray(xs[lane]))
        np.testing.assert_allclose(out[lane].numpy(), np.asarray(j_out), **TOL)
        np.testing.assert_allclose(jac[lane].numpy(), np.asarray(j_jac), **TOL)
