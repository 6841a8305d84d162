"""Parity of the PyTorch port's Hodgkin-Huxley models, small inverse and
Kvaerno3 stepper with the JAX package.

Models: the right-hand sides, their Jacobians (forward mode on both sides),
the steady-state initial values and the stimulus at its edges, for the three
single-compartment variants and the multi-compartment coupling, and the
config adapters; float64 rtol 1e-12. ``inv_small`` and one Kvaerno3 step
(values, error estimate, the first-order JVP through the stage-solve rule
against ``jax.jvp`` of the reference, which applies its ``custom_jvp``, and
reverse mode through the rule against ``jax.grad``): float64 rtol 1e-12, on HH reduced-4 and full and on stiff
van der Pol (damping 50, h = 0.05). Inputs are made with numpy from a seed.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.ops.small_inv import inv_small as j_inv_small
from ode_uncertainty_tpu.utils.config import instantiate as j_instantiate
from ode_uncertainty_tpu_torch import models as tm
from ode_uncertainty_tpu_torch import solvers as ts
from ode_uncertainty_tpu_torch.ops.small_inv import inv_small as t_inv_small
from ode_uncertainty_tpu_torch.utils.config import build_config as t_build_config
from ode_uncertainty_tpu_torch.utils.config import load_experiment

TOL = dict(rtol=1e-12, atol=1e-14)
F64 = torch.float64

MODELS = {
    "reduced-4": lambda m: m.hodgkin_huxley("reduced-4"),
    "reduced-1": lambda m: m.hodgkin_huxley("reduced-1"),
    "full": lambda m: m.hodgkin_huxley("full"),
    "c2_reduced-4": lambda m: m.multi_compartment_hodgkin_huxley(
        "reduced-4", 2, [1.0], 1.0, g_Na=[25.0, 20.0], g_K=[7.0, 10.0]),
    "c3_reduced-1": lambda m: m.multi_compartment_hodgkin_huxley(
        "reduced-1", 3, [1.0, 0.5], 1.3, A=[4.15e-5, 4.15e-5, 5e-5], V_T=[-70.0, -50.0, -60.0]),
}


def _models(name):
    jmod, tmod = MODELS[name](jm), MODELS[name](tm)
    assert jmod.name == tmod.name and jmod.dim == tmod.dim
    return jmod, tmod


def _ncomp(jmod):
    return int(jmod.name.rsplit("_x", 1)[1]) if "_x" in jmod.name else 1


def _x0(jmod):
    """Initial voltages [1, compartments]."""
    return np.linspace(-70.0, -64.0, _ncomp(jmod))[None, :]


def _state(jmod, seed):
    """A state near the steady state with V moved into the spike range."""
    y = np.asarray(jmod.build_initial_value(jnp.asarray(_x0(jmod)), jmod.params))
    y = y + 0.01 * np.random.default_rng(seed).standard_normal(y.shape)
    y[0, :: jmod.dim // _ncomp(jmod)] = np.linspace(-40.0, -20.0, _ncomp(jmod))
    return y


@pytest.mark.parametrize("name", list(MODELS))
def test_steady_state_matches_jax(name):
    jmod, tmod = _models(name)
    x0 = _x0(jmod)
    ref = np.asarray(jmod.build_initial_value(jnp.asarray(x0), jmod.params))
    got = tmod.build_initial_value(torch.tensor(x0, dtype=F64), tmod.params).numpy()
    assert got.shape == ref.shape == (1, jmod.dim)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_rhs_and_jacobian_match_jax(name):
    jmod, tmod = _models(name)
    y = _state(jmod, seed=0)
    for t in (9.99, 10.0, 50.0, 90.0, 90.01):
        ref = np.asarray(jmod.rhs(jnp.asarray(t), jnp.asarray(y), jmod.params))
        tt = torch.tensor(t, dtype=F64)
        got = tmod.rhs(tt, torch.tensor(y), tmod.params).numpy()
        np.testing.assert_allclose(got, ref, **TOL)
        j_ref = np.asarray(jax.jacfwd(lambda yy: jmod.rhs(jnp.asarray(t), yy, jmod.params))(jnp.asarray(y)))
        j_got = torch.func.jacfwd(lambda yy: tmod.rhs(tt, yy, tmod.params))(torch.tensor(y)).numpy()
        np.testing.assert_allclose(j_got, j_ref, **TOL)


def test_rhs_takes_a_batch_of_parameters():
    jmod, tmod = _models("full")
    y = _state(jmod, seed=1)
    g_na = np.array([10.0, 25.0, 60.0])
    params = {k: v.expand(3).clone() for k, v in tmod.params.items()}
    params["g_Na"] = torch.tensor(g_na, dtype=F64)
    got = tmod.rhs(torch.tensor(20.0, dtype=F64), torch.tensor(y), params).numpy()
    for b, g in enumerate(g_na):
        ref = jmod.rhs(jnp.asarray(20.0), jnp.asarray(y), {**jmod.params, "g_Na": jnp.asarray(g)})
        np.testing.assert_allclose(got[b], np.asarray(ref), **TOL)


def test_input_current_at_the_stimulus_edges():
    # the models packages re-export a factory of the same name as the module
    jhh = importlib.import_module("ode_uncertainty_tpu.models.hodgkin_huxley")
    thh = importlib.import_module("ode_uncertainty_tpu_torch.models.hodgkin_huxley")
    for dtype, jdt in ((F64, jnp.float64), (torch.float32, jnp.float32)):
        t = np.array([9.99, 10.0, 50.0, 90.0, 90.01])
        ref = np.asarray(jhh.input_current(jnp.asarray(t, jdt)))
        got = thh.input_current(torch.tensor(t, dtype=dtype)).numpy()
        np.testing.assert_array_equal(got, ref.astype(got.dtype))
        np.testing.assert_array_equal(got != 0, [False, True, True, True, False])


@pytest.mark.parametrize("experiment", ["params/hodgkinhuxley1_r4", "params/hodgkinhuxley7_full",
                                        "params/hodgkinhuxley2_c2_r4", "params/hodgkinhuxley6_c2_r1"])
def test_config_adapters_build_the_same_model(experiment):
    raw = load_experiment(experiment)
    jmod = j_instantiate(raw["ode_builder"])
    tcfg = t_build_config(raw, {"tN": 0.1})
    tmod = tcfg["ode_builder"]
    assert tmod.name == jmod.name and tmod.dim == jmod.dim
    assert sorted(tmod.params) == sorted(jmod.params)
    for k, v in jmod.params.items():
        np.testing.assert_array_equal(tmod.params[k].numpy(), np.asarray(v, np.float64))
    assert isinstance(tcfg["solver_builder"], ts.Kvaerno3)
    assert tcfg["solver_builder"].h == 0.01 and tcfg["solver_builder"].newton_iters == 6
    y = _state(jmod, seed=2)
    ref = np.asarray(jmod.rhs(jnp.asarray(30.0), jnp.asarray(y), jmod.params))
    got = tmod.rhs(torch.tensor(30.0, dtype=F64), torch.tensor(y), tmod.params).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_inv_small_matches_jax(n):
    rng = np.random.default_rng(n)
    a = np.eye(n) - 0.05 * rng.standard_normal((3, n, n))
    ref = np.asarray(j_inv_small(jnp.asarray(a)))
    got = t_inv_small(torch.tensor(a)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got @ a, np.broadcast_to(np.eye(n), a.shape), atol=1e-12)


def _step_case(case):
    """(JAX model, port model, step size, t, state) of one Kvaerno3 step."""
    if case == "vdp50":
        jmod, tmod = jm.van_der_pol(damping=50.0), tm.van_der_pol(damping=50.0)
        return jmod, tmod, 0.05, 0.0, np.array([[2.0, 0.0]]).reshape(jmod.n_order, jmod.dim)
    jmod, tmod = _models(case)
    return jmod, tmod, 0.01, 10.0, _state(jmod, seed=3)


@pytest.mark.parametrize("case", ["reduced-4", "full", "vdp50"])
def test_kvaerno3_step_and_its_jvp_match_jax(case):
    jmod, tmod, h, t, y = _step_case(case)
    jsol, tsol = js.kvaerno3(h), ts.kvaerno3(h)
    jt, tt = jnp.asarray(t, jnp.float64), torch.tensor(t, dtype=F64)
    x_ref, eps_ref = jsol.step(jmod.rhs, jmod.params, jt, jnp.asarray(y))
    x_got, eps_got = tsol.step(tmod.rhs, tmod.params, tt, torch.tensor(y))
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_ref), **TOL)
    np.testing.assert_allclose(eps_got.numpy(), np.asarray(eps_ref), rtol=1e-10, atol=1e-14)

    v = np.random.default_rng(4).standard_normal(y.shape)
    _, d_ref = jax.jvp(lambda yy: jsol.step(jmod.rhs, jmod.params, jt, yy)[0], (jnp.asarray(y),), (jnp.asarray(v),))
    _, d_got = torch.func.jvp(lambda yy: tsol.step(tmod.rhs, tmod.params, tt, yy)[0],
                              (torch.tensor(y),), (torch.tensor(v),))
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), **TOL)


def test_kvaerno3_step_takes_a_batch_and_solves_stiff_problems():
    jmod, tmod = jm.van_der_pol(damping=50.0), tm.van_der_pol(damping=50.0)
    x0 = np.array([[2.0, 0.0]]).reshape(jmod.n_order, jmod.dim)
    ref = js.solve(js.kvaerno3(0.05), jmod, 0.0, jnp.asarray(x0), 40)
    got = ts.solve(ts.kvaerno3(0.05), tmod, 0.0, torch.tensor(x0), 40)
    assert np.isfinite(got["x"].numpy()).all()
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(ref["x"]), rtol=1e-10, atol=1e-12)
    # a batch of parameters steps each lane as its own problem
    damping = torch.tensor([5.0, 50.0], dtype=F64)
    xb, _ = ts.kvaerno3(0.05).step(tmod.rhs, {"damping": damping}, torch.tensor(0.0, dtype=F64),
                                   torch.tensor(x0).expand(2, *x0.shape))
    for b in range(2):
        xs, _ = ts.kvaerno3(0.05).step(tmod.rhs, {"damping": damping[b]}, torch.tensor(0.0, dtype=F64),
                                       torch.tensor(x0))
        np.testing.assert_allclose(xb[b].numpy(), xs.numpy(), rtol=1e-13)


def test_kvaerno3_rule_has_no_second_order_yet():
    # reverse mode through the stage-solve rule (StageSolve.backward, its
    # transpose) against jax.grad through the reference's custom_jvp
    jmod, tmod, h, t, y = _step_case("reduced-4")
    sol = ts.kvaerno3(h)
    g_na = tmod.params["g_Na"].clone().requires_grad_(True)
    params = {**tmod.params, "g_Na": g_na}
    x_next, _ = sol.step(tmod.rhs, params, torch.tensor(t, dtype=F64), torch.tensor(y))
    x_next.sum().backward()
    jsol, jt = js.kvaerno3(h), jnp.asarray(t, jnp.float64)
    ref = jax.grad(lambda g: jnp.sum(jsol.step(jmod.rhs, {**jmod.params, "g_Na": g}, jt, jnp.asarray(y))[0]))(
        jnp.asarray(jmod.params["g_Na"], jnp.float64))
    assert float(g_na.grad) != 0.0
    np.testing.assert_allclose(g_na.grad.numpy(), np.asarray(ref), **TOL)
