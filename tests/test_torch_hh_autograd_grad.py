"""The port's ``make_nll`` + autograd gradient through the Kvaerno3 step (the
stage-solve rule at second order) against ``jax.grad`` of the JAX package's
``make_nll``, on Hodgkin-Huxley reduced-4 with ``initial_state_parametrized``
(each lane's initial state is the steady state at V = -70 under its own
parameters: with V_T varied, the gradient also flows through the initial
state).

The rig crosses the stimulus onset: t0 = 9.9, 12 steps, V observed after
each (both ``make_nll``s accumulate the time, t += h, so the stimulus
switches on at their eleventh step), g_Na, g_K and V_T varied. The port runs the
3 points at gamma^1/2 = 0.1 and 0 as 6 lanes of one call (one gamma^1/2 per
lane). The NLLs and d NLL / d gamma^1/2 agree at float64 rtol 1e-9; d NLL /
d p_norm at rtol 1e-9 above a floor of 1e-9 of the coordinate's largest
|gradient| over the lanes (a lane where the NLL is flat in a coordinate,
~1e-10 there, carries rounding of ~1e-17).
Rigs from tests/test_torch_hh_nll.py; about 100 s on one CPU core, most of
it JAX compiling ``jax.grad`` of its ``make_nll``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ode_uncertainty_tpu.inference import make_nll as j_make_nll
from ode_uncertainty_tpu_torch.inference import make_nll as t_make_nll
from test_torch_hh_nll import TOL, hh_rigs, port_args

STEPS = 12
GAMMAS = (0.1, 0.0)
OPTIMIZED = ("g_Na", "g_K", "V_T")
V0 = np.array([[-70.0]])


def test_make_nll_autograd_matches_jax_grad_with_initial_state_parametrized():
    jrig, trig = hh_rigs("reduced-4", "float64", 9.9, STEPS, optimized=OPTIMIZED)
    p = np.repeat(np.random.default_rng(1).uniform(size=(3, len(OPTIMIZED))), len(GAMMAS), axis=0)
    gs = np.tile(GAMMAS, 3)

    nll = j_make_nll(*jrig, x0_raw=jnp.asarray(V0), initial_state_parametrized=True)
    q = jnp.eye(jrig[0].dim)
    vg = jax.vmap(jax.value_and_grad(lambda x, g: nll(x, q, g), argnums=(0, 1)))
    vals, (dp, dg) = jax.jit(vg)(jnp.asarray(p), jnp.asarray(gs))

    t_nll = t_make_nll(*port_args(trig), x0_raw=torch.as_tensor(V0), initial_state_parametrized=True)
    x = torch.as_tensor(p).requires_grad_(True)
    g = torch.as_tensor(gs).requires_grad_(True)
    got = t_nll(x, trig.q_sqrt, g[:, None, None])
    got.sum().backward()

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(vals), **TOL["float64"])
    assert np.isfinite(np.asarray(dp)).all() and np.abs(np.asarray(dp)).min() > 0.0
    ref = np.asarray(dp)
    err = np.abs(x.grad.numpy() - ref) / (np.abs(ref) + np.abs(ref).max(axis=0))
    assert err.max() <= 1e-9, err
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(dg), **TOL["float64"])
    # the flag matters: the rig's one rest state gives other values
    shared = t_make_nll(*port_args(trig))(torch.as_tensor(p), trig.q_sqrt, torch.as_tensor(gs)[:, None, None])
    assert np.abs(shared.numpy() - got.detach().numpy()).max() > 1e-6
