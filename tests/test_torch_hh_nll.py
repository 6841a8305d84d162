"""Parity of the Kvaerno3 plain version of the nll_fwd kernel (``ChainMath``'s
Kvaerno3 branch, ``nll_plain``) with the JAX package's ``make_nll_tiles`` on
Hodgkin-Huxley reduced-4, the kernel wrapper's CPU route on HH, and
``supports`` for the implicit step.

The onset rig starts at t0 = 9.98 from the rest state and runs 4 steps with
an observation of V after each, so the tiles' time rule (step times from the
step index) switches the stimulus on at the third step (t = 10). The JAX
tile program runs eagerly (``jax.disable_jit``): compiled, its unrolled
Kvaerno3 steps take minutes to build on one CPU core. Tolerances: float64
rtol 1e-9; float32 rtol 5e-4 / atol 5e-3 (the implicit tolerances of
tests/test_pallas_ekf.py:314). The helpers here also build the rigs of
tests/test_torch_hh_full.py, test_torch_hh_xla.py, test_torch_hh_make_nll.py
and test_torch_hh_time_rules.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.filters import SqrtEKF as JEKF
from ode_uncertainty_tpu.inference import make_obs_model as j_obs
from ode_uncertainty_tpu.inference import make_param_spec as j_spec
from ode_uncertainty_tpu.ops import const_diag as j_const_diag
from ode_uncertainty_tpu.ops.pallas_ekf import make_nll_tiles as j_tiles
from ode_uncertainty_tpu_torch import solvers as ts
from ode_uncertainty_tpu_torch.filters import SqrtEKF as TEKF
from ode_uncertainty_tpu_torch.ops import nll_kernel
from ode_uncertainty_tpu_torch.utils.carry import rig_from_numpy
from ode_uncertainty_tpu_torch.utils.config import load_experiment

HH_RANGES = load_experiment("params/hodgkinhuxley1_r4")["params_range"]
TOL = {
    "float64": dict(rtol=1e-9, atol=0.0),
    "float32": dict(rtol=5e-4, atol=5e-3),
}
_CACHE: dict = {}


def jax_hh_rig(variant, dtype, t0, steps, x0=None, seed=0, optimized=("g_Na", "g_K")):
    """A JAX HH rig: Kvaerno3 at h = 0.01 from t0 (at the rest state unless
    ``x0`` [1, n] is given), V observed after every step, the observations
    a float64 solve plus N(0, 0.1) noise from numpy's default_rng(seed),
    the parameters named in ``optimized`` varied."""
    jdt = getattr(jnp, dtype)
    m, h = jm.hodgkin_huxley(variant), 0.01
    sol = js.kvaerno3(h)
    n = m.dim
    if x0 is None:
        x0 = m.build_initial_value(jnp.array([[-70.0]]), m.params)
    gt = js.solve(sol, m, t0, jnp.asarray(x0, jnp.float64), steps)
    idx = np.arange(1, steps + 1)
    ys = np.asarray(gt["x"])[idx].reshape(steps, n)
    ys = ys + np.sqrt(0.1) * np.random.default_rng(seed).standard_normal(ys.shape)
    obs = j_obs(np.eye(n)[:1], np.asarray(gt["t"])[idx], ys, 0.1, t0, h, steps, dtype=jdt)
    spec = j_spec(m.params, HH_RANGES, {k: k in optimized for k in HH_RANGES}, dtype=jdt)
    ekf = JEKF(disable_cov_update=True)
    state0 = ekf.init_state(t0, jnp.asarray(x0, jdt), j_const_diag(n, 1e-6, jdt), obs.obs_dim)
    return m, sol, ekf, spec, obs, state0, steps


def to_numpy(jrig):
    """The JAX rig's values as numpy arrays (the input of rig_from_numpy)."""
    m, sol, ekf, spec, obs, state0, num_steps = jrig
    mask = np.zeros(spec.num_full, bool)
    mask[np.asarray(spec.opt_indices)] = True
    return {
        "model": m.name,
        "params": {k: np.array(v) for k, v in m.params.items()},
        "tableau": sol.name,
        "newton_iters": sol.newton_iters,
        "h": sol.h,
        "num_steps": num_steps,
        "t0": float(state0.t),
        "disable_cov_update": ekf.disable_cov_update,
        "spec_keys": spec.keys,
        "spec_shapes": spec.shapes,
        "defaults": np.asarray(spec.defaults_flat),
        "mins": np.asarray(spec.mins_flat),
        "maxs": np.asarray(spec.maxs_flat),
        "opt_mask": mask,
        "x0": np.array(state0.x),
        "P0_sqrt": np.array(state0.P_sqrt),
        "H": np.array(obs.H),
        "R_sqrt": np.array(obs.R_sqrt),
        "q_sqrt": np.eye(m.dim),
        "ys": np.array(obs.ys),
        "flags": np.array(obs.flags),
        "index_map": np.array(obs.index_map),
    }


def hh_rigs(variant, dtype, t0, steps, x0=None, optimized=("g_Na", "g_K")):
    """(JAX rig, port rig), cached per process."""
    key = (variant, dtype, t0, steps, None if x0 is None else np.asarray(x0).tobytes(), tuple(optimized))
    if key not in _CACHE:
        jrig = jax_hh_rig(variant, dtype, t0, steps, x0, optimized=optimized)
        _CACHE[key] = (jrig, rig_from_numpy(to_numpy(jrig), device="cpu", dtype=getattr(torch, dtype)))
    return _CACHE[key]


def port_args(trig):
    return trig.model, trig.solver, trig.ekf, trig.spec, trig.obs, trig.state0, trig.num_steps


def points(n=4, seed=1):
    """Normalized (g_K, g_Na) points."""
    return np.random.default_rng(seed).uniform(size=(n, 2))


def tiles_vs_plain(variant, dtype, t0, steps, gamma_sqrt):
    """(JAX make_nll_tiles, the port's plain version) on the same points."""
    jrig, trig = hh_rigs(variant, dtype, t0, steps)
    jdt = getattr(jnp, dtype)
    p = points()
    with jax.disable_jit():
        ref = np.asarray(j_tiles(*jrig, np.eye(trig.model.dim))(jnp.asarray(p, jdt), jnp.asarray(gamma_sqrt, jdt)))
    got = nll_kernel.make_nll_tiles(*port_args(trig), trig.q_sqrt)(torch.as_tensor(p), gamma_sqrt).numpy()
    assert got.dtype == np.dtype(dtype) and np.isfinite(got).all()
    return got, ref


@pytest.mark.parametrize("dtype,gamma_sqrt", [("float64", 0.1), ("float64", 0.0), ("float32", 0.1)])
def test_plain_version_matches_jax_tiles_across_the_onset(dtype, gamma_sqrt):
    _, trig = hh_rigs("reduced-4", dtype, 9.98, 4)
    cm = nll_kernel.build_chain_math(trig.model, trig.solver, trig.spec, trig.obs, trig.state0, trig.q_sqrt)
    # the stimulus switches on inside the rig: at the third step in float64
    # (t = 10 exactly), at the fourth in float32 (t0 rounds below 9.98)
    assert cm.t_start(1) < 10.0 <= cm.t_start(3)
    got, ref = tiles_vs_plain("reduced-4", dtype, 9.98, 4, gamma_sqrt)
    np.testing.assert_allclose(got, ref, **TOL[dtype])


def test_kernel_wrapper_runs_the_plain_version_on_cpu_and_has_no_gradient():
    # reduced-4 has both kernels: on CPU tensors the wrapper runs their
    # plain versions, and only a CUDA launch counts
    _, trig = hh_rigs("reduced-4", "float64", 9.98, 4)
    assert nll_kernel.supports(trig.model, trig.solver, trig.ekf, trig.obs)
    assert nll_kernel.supports(trig.model, trig.solver, trig.ekf, trig.obs, grad=True)
    fn = nll_kernel.make_nll_cuda(*port_args(trig), trig.q_sqrt)
    p = torch.as_tensor(points(3, seed=2))
    g = torch.ones(3, dtype=torch.float64)
    before = dict(nll_kernel.launches)
    got = fn(p, 0.1)
    dphys, dgamma = fn.grad(fn.physical(p), 0.1, g)
    assert nll_kernel.launches == before  # only a CUDA launch counts
    assert torch.equal(got, nll_kernel.nll_plain(fn.cm, fn.physical(p), fn.ys, 0.1))
    want = nll_kernel.nll_grad_plain(fn.cm, fn.physical(p), fn.ys, 0.1, g)
    assert torch.equal(dphys, want[0]) and torch.equal(dgamma, want[1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn.launch(fn.physical(p), 0.1)
    # HH full (n = 8) and reduced-1 (n = 7) have their gradient units: on
    # CPU tensors the wrapper runs the plain gradient
    for variant in ("full", "reduced-1"):
        _, other = hh_rigs(variant, "float64", 9.98, 4)
        assert nll_kernel.supports(other.model, other.solver, other.ekf, other.obs, grad=True)
        fn_other = nll_kernel.make_nll_cuda(*port_args(other), other.q_sqrt)
        dphys, dgamma = fn_other.grad(fn_other.physical(p), 0.1, g)
        want = nll_kernel.nll_grad_plain(fn_other.cm, fn_other.physical(p), fn_other.ys, 0.1, g)
        assert torch.equal(dphys, want[0]) and torch.equal(dgamma, want[1])
    assert nll_kernel.launches == before
    # HH with an explicit tableau has its gradient unit too
    cm = nll_kernel.build_chain_math(trig.model, ts.dopri65(0.01), trig.spec, trig.obs, trig.state0, trig.q_sqrt)
    fn_erk = nll_kernel.NllFwd(cm, trig.spec, trig.obs.ys)
    dphys, dgamma = fn_erk.grad(fn_erk.physical(p), 0.1, g)
    want = nll_kernel.nll_grad_plain(cm, fn_erk.physical(p), fn_erk.ys, 0.1, g)
    assert torch.equal(dphys, want[0]) and torch.equal(dgamma, want[1])
    # a chain without a gradient unit (HH with two observed rows, built
    # around the wrapper by hand): the wrapper raises on either device, and
    # autograd through the forward may not stand in for it
    cm2 = dataclasses.replace(cm, L=2, H=[[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]], R=[[0.1, 0.0], [0.0, 0.1]])
    fn_l2 = nll_kernel.NllFwd(cm2, trig.spec, torch.cat([trig.obs.ys, trig.obs.ys], 1))
    with pytest.raises(NotImplementedError, match="no nll_bwd instantiation"):
        fn_l2.grad(fn_l2.physical(p), 0.1, g)
    with pytest.raises(NotImplementedError, match="no nll_bwd instantiation"):
        fn_l2(p.clone().requires_grad_(True), 0.1).sum().backward()


def test_supports_rules_for_the_implicit_step():
    _, trig = hh_rigs("reduced-4", "float64", 9.98, 4)
    args = dict(model=trig.model, solver=trig.solver, ekf=trig.ekf, obs=trig.obs)
    assert nll_kernel.supports(**args)
    # HH under every explicit tableau is instantiated at L = 1
    for tab in ("heun_euler", "bs32", "rkf45", "dopri65"):
        assert nll_kernel.supports(**{**args, "solver": getattr(ts, tab)(0.01)}, grad=True)
    assert not nll_kernel.supports(**{**args, "ekf": TEKF(disable_cov_update=False)})
    from ode_uncertainty_tpu_torch import models as tm

    mc = tm.multi_compartment_hodgkin_huxley("reduced-4", 2)
    assert not nll_kernel.supports(**{**args, "model": mc})
    # the implicit step on the tile models, at every L in 1..n
    for name, n in (("lotka_volterra", 2), ("lorenz", 3), ("exponential", 1)):
        assert all(nll_kernel.instantiated(name, "kvaerno3", n, L) for L in range(1, n + 1))
        assert not nll_kernel.instantiated(name, "kvaerno3", n, n + 1)
    # HH at L = 2 is not instantiated
    two = type(trig.obs)(torch.eye(4, dtype=torch.float64)[:2], 0.1 * torch.eye(2, dtype=torch.float64),
                         torch.cat([trig.obs.ys, trig.obs.ys], 1), trig.obs.flags, trig.obs.index_map)
    assert not nll_kernel.supports(**{**args, "obs": two})
