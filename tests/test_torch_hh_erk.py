"""The plain versions of the NLL kernels on the single-compartment
Hodgkin-Huxley variants under the explicit tableaus (``nll_plain``,
``nll_grad_plain`` through ``ChainMath._erk_step``), against the JAX package:
its tile evaluator ``make_nll_tiles`` (run eagerly under ``jax.disable_jit``)
for the values, ``jax.grad`` of its XLA ``make_nll`` for the gradient.

The rigs are those of tests/test_torch_hh_nll.py with the solver swapped:
t0 = 9.98 from the rest state, 4 steps at h = 0.01 (the stimulus switches on
at the third, t = 10), V observed after each, the observations a float64
Kvaerno3 solve plus noise, g_Na and g_K varied. Reduced-4 under every
explicit tableau, and its gradient under RKF45 with the XLA path's time rule
(``accumulate_time``); reduced-1 and full: tests/test_torch_hh_erk_variants.py.
Tolerance: float64 rtol 1e-9 (values and gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.inference import make_nll as j_make_nll
from ode_uncertainty_tpu.ops.pallas_ekf import make_nll_tiles as j_tiles
from ode_uncertainty_tpu_torch.ops import nll_kernel
from ode_uncertainty_tpu_torch.utils.carry import rig_from_numpy
from test_torch_hh_grad import port_grads
from test_torch_hh_nll import TOL, jax_hh_rig, points, port_args, to_numpy

T0, STEPS = 9.98, 4
_CACHE: dict = {}


def erk_rigs(variant, tableau):
    """(JAX rig, port rig) of the onset rig under ``tableau``, float64."""
    key = (variant, tableau)
    if key not in _CACHE:
        jrig = jax_hh_rig(variant, "float64", T0, STEPS)
        raw = to_numpy(jrig)
        raw["tableau"] = tableau
        jrig = (jrig[0], getattr(js, tableau)(0.01), *jrig[2:])
        _CACHE[key] = (jrig, rig_from_numpy(raw, device="cpu", dtype=torch.float64))
    return _CACHE[key]


def check_values(variant, tableau):
    """The plain value against the tiles at gamma^1/2 = 0.1 and 0."""
    jrig, trig = erk_rigs(variant, tableau)
    assert nll_kernel.supports(trig.model, trig.solver, trig.ekf, trig.obs, grad=True)
    p = points()
    nll = nll_kernel.make_nll_tiles(*port_args(trig), trig.q_sqrt)
    tiles = j_tiles(*jrig, np.eye(trig.model.dim))
    for gamma_sqrt in (0.1, 0.0):
        with jax.disable_jit():
            ref = np.asarray(tiles(jnp.asarray(p), jnp.asarray(gamma_sqrt, jnp.float64)))
        got = nll(torch.as_tensor(p), gamma_sqrt).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, **TOL["float64"])


@pytest.mark.parametrize("tableau", ["heun_euler", "bs32", "rkf45", "dopri65"])
def test_plain_values_match_jax_tiles_across_the_onset(tableau):
    check_values("reduced-4", tableau)


@pytest.mark.parametrize("gamma_sqrt", [0.1, 0.0])
def test_plain_gradient_matches_jax_grad_of_make_nll(gamma_sqrt):
    jrig, trig = erk_rigs("reduced-4", "rkf45")
    if "vg" not in _CACHE:
        nll, q = j_make_nll(*jrig), jnp.eye(jrig[0].dim)
        vg = jax.value_and_grad(lambda x, g: nll(x, q, g), argnums=(0, 1))
        _CACHE["vg"] = jax.jit(jax.vmap(vg, in_axes=(0, None)))
    p = points()
    vals, (dp, dg) = _CACHE["vg"](jnp.asarray(p), jnp.asarray(gamma_sqrt, jnp.float64))
    got_vals, got_dp, got_dg = port_grads(trig, p, gamma_sqrt, accumulate_time=True)
    assert np.isfinite(np.asarray(dp)).all() and np.abs(np.asarray(dp)).min() > 0.0
    np.testing.assert_allclose(got_vals, np.asarray(vals), **TOL["float64"])
    np.testing.assert_allclose(got_dp, np.asarray(dp), **TOL["float64"])
    np.testing.assert_allclose(got_dg, np.asarray(dg), **TOL["float64"])
