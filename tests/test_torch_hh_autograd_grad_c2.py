"""The port's ``make_nll`` + autograd gradient through the Kvaerno3 step on the
two-compartment Hodgkin-Huxley model of params/hodgkinhuxley2_c2_r4 (n = 8,
V of both compartments observed, g_Na and g_K per compartment: 4 rows),
against central differences of the JAX package's float64 ``make_nll``, as
tests/test_torch_hh_grad_full.py holds the n = 8 plain gradient: jax.grad of
``make_nll`` does not compile in reasonable time at n = 8 on one CPU core.

The rig crosses the stimulus onset: t0 = 9.9 from the rest state, 14 steps
(both ``make_nll``s accumulate the time, so the stimulus switches on at
their eleventh step); the observations are a float64 solve plus N(0, 0.1)
noise from numpy's default_rng(0), projected by the experiment's H. 4 random normalized points at gamma^1/2
= 0.1 and 0 (8 lanes of one port call, one gamma^1/2 per lane). The NLLs
agree at float64 rtol 1e-9; d NLL / d p_norm and d NLL / d gamma^1/2 are
held to central differences with a step of 1e-5 in every coordinate at a
lane-normalized error |port - differences| / (|differences| + 1) <= 1e-6.
Across the onset the NLL is nearly flat in g_Na and g_K (gradients of
1e-7-1e-4 in the normalized coordinates), where differences with a step of
1e-5 carry rounding of ~1e-8: so the gradient is also held to differences
with a step of 1e-3 (truncation ~1e-4 of the gradient) within 1e-3 of the
coordinate's largest |difference| over the lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.filters import SqrtEKF as JEKF
from ode_uncertainty_tpu.inference import make_nll as j_make_nll
from ode_uncertainty_tpu.inference import make_obs_model as j_obs
from ode_uncertainty_tpu.inference import make_param_spec as j_spec
from ode_uncertainty_tpu.ops import const_diag as j_const_diag
from ode_uncertainty_tpu_torch.inference import make_nll as t_make_nll
from ode_uncertainty_tpu_torch.utils.carry import rig_from_numpy
from ode_uncertainty_tpu_torch.utils.config import load_experiment, parse_literal
from test_torch_hh_nll import TOL, port_args, to_numpy

EXPERIMENT = "params/hodgkinhuxley2_c2_r4"
T0, STEPS = 9.9, 14
GAMMAS = (0.1, 0.0)
FD_STEP, FD_TOL = 1e-5, 1e-6
COARSE_STEP, COARSE_TOL = 1e-3, 1e-3


def jax_c2_rig(t0, steps, seed=0):
    raw = load_experiment(EXPERIMENT)
    m, h = jm.multi_compartment_hodgkin_huxley(**raw["ode_builder"]["init_args"]), 0.01
    sol = js.kvaerno3(h)
    x0 = m.build_initial_value(jnp.array([[-70.0, -70.0]]), m.params)
    gt = js.solve(sol, m, t0, jnp.asarray(x0, jnp.float64), steps)
    h_mat = np.asarray(parse_literal(raw["measurement_matrix"]), float)
    idx = np.arange(1, steps + 1)
    ys = np.asarray(gt["x"])[idx].reshape(steps, -1)
    ys = ys + np.sqrt(0.1) * np.random.default_rng(seed).standard_normal(ys.shape)
    obs = j_obs(h_mat, np.asarray(gt["t"])[idx], ys, 0.1, t0, h, steps, dtype=jnp.float64)
    spec = j_spec(m.params, raw["params_range"], raw["params_optimized"], dtype=jnp.float64)
    ekf = JEKF(disable_cov_update=True)
    state0 = ekf.init_state(t0, jnp.asarray(x0, jnp.float64), j_const_diag(m.dim, 1e-6, jnp.float64), obs.obs_dim)
    return m, sol, ekf, spec, obs, state0, steps


def test_make_nll_autograd_matches_jax_differences_on_c2():
    jrig = jax_c2_rig(T0, STEPS)
    trig = rig_from_numpy(to_numpy(jrig), device="cpu", dtype=torch.float64)
    dim = trig.spec.num_opt
    assert dim == 4
    p = np.repeat(np.random.default_rng(1).uniform(size=(4, dim)), len(GAMMAS), axis=0)
    gs = np.tile(GAMMAS, 4)

    x = torch.as_tensor(p).requires_grad_(True)
    g = torch.as_tensor(gs).requires_grad_(True)
    got = t_make_nll(*port_args(trig))(x, trig.q_sqrt, g[:, None, None])
    got.sum().backward()
    got_grads = np.concatenate([x.grad.numpy(), g.grad.numpy()[:, None]], axis=1)

    # every lane and its 2 (dim + 1) neighbours at both steps, in one jit
    nll, q = j_make_nll(*jrig), jnp.eye(jrig[0].dim)
    shifts = np.concatenate([np.zeros((1, dim + 1))]
                            + [sign * step * np.eye(dim + 1) for step in (FD_STEP, COARSE_STEP) for sign in (1, -1)])
    xs = np.concatenate([p + s[:dim] for s in shifts])
    gg = np.concatenate([gs + s[dim] for s in shifts])
    vals = np.asarray(jax.jit(jax.vmap(lambda a, b: nll(a, q, b)))(jnp.asarray(xs), jnp.asarray(gg)))
    vals = vals.reshape(len(shifts), len(p))
    k = dim + 1
    fd = ((vals[1:1 + k] - vals[1 + k:1 + 2 * k]) / (2.0 * FD_STEP)).T
    coarse = ((vals[1 + 2 * k:1 + 3 * k] - vals[1 + 3 * k:]) / (2.0 * COARSE_STEP)).T

    np.testing.assert_allclose(got.detach().numpy(), vals[0], **TOL["float64"])
    assert np.isfinite(fd).all() and np.abs(coarse[:, :dim]).max() > 1e-5
    err = np.abs(got_grads - fd) / (np.abs(fd) + 1.0)
    assert err.max() <= FD_TOL, err.max(axis=0)
    coarse_err = np.abs(got_grads - coarse) / np.abs(coarse).max(axis=0)
    assert coarse_err.max() <= COARSE_TOL, coarse_err.max(axis=0)
