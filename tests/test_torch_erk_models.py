"""The plain versions of the explicit-step NLL kernels (``nll_plain``,
``nll_grad_plain`` in ``ops/nll_kernel.py``) on every model with a
hand-written tile RHS and JVP (Lotka-Volterra, Lorenz, van der Pol,
pendulum, logistic, exponential) and every ERK tableau, against the JAX
package: its tile evaluator ``make_nll_tiles`` (the kernels' own math, run
eagerly under ``jax.disable_jit``: its jit unrolls every step and compiles
for tens of seconds) and its XLA ``make_nll`` with ``jax.grad``.

Rigs: ``STEPS`` (4) steps at h = 0.01 with an observation every 2 (both
interval kinds), L = 1 (the first state observed) or L = n (the whole
state), every parameter optimized over a box of 0.5 to 1.5 times its
default, 8 lanes and observations from numpy seeds, at gamma^1/2 = 0.1 and
0. This file runs every model with RKF45 (the other tableaus on van der
Pol and Lorenz: tests/test_torch_erk_tableaus.py, which shares its rigs).
JAX's ``jax.grad`` of ``make_nll`` takes 5-18 s to trace and compile a rig
on one CPU core, so the gradient is held at L = 1 (Lotka-Volterra's in
tests/test_torch_grad.py), the values at L = 1 and L = n. Tolerances:
float64 rtol 1e-9; float32 rtol 2e-4 / atol 1e-4 (values) and 5e-3 /
1e-4 (gradients), those of tests/test_pallas_ekf.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.filters import SqrtEKF as JEKF
from ode_uncertainty_tpu.inference import make_nll as j_make_nll
from ode_uncertainty_tpu.inference import make_obs_model as j_obs
from ode_uncertainty_tpu.inference import make_param_spec as j_spec
from ode_uncertainty_tpu.ops import const_diag as j_const_diag
from ode_uncertainty_tpu.ops.pallas_ekf import make_nll_tiles as j_tiles
from ode_uncertainty_tpu_torch import models as tm
from ode_uncertainty_tpu_torch import solvers as ts
from ode_uncertainty_tpu_torch.filters import SqrtEKF as TEKF
from ode_uncertainty_tpu_torch.ops import nll_kernel
from ode_uncertainty_tpu_torch.utils.carry import rig_from_numpy

TOL_VAL = {"float64": dict(rtol=1e-9, atol=0.0), "float32": dict(rtol=2e-4, atol=1e-4)}
TOL_GRAD = {"float64": dict(rtol=1e-9, atol=0.0), "float32": dict(rtol=5e-3, atol=1e-4)}
STEPS, EVERY, LANES = 4, 2, 8
# model -> (JAX factory, x0 [N, D]); the state size n is N * D
MODELS = {
    "lotka_volterra": (jm.lotka_volterra, [[1.0, 1.0]]),
    "lorenz": (jm.lorenz, [[1.0, 1.0, 1.0]]),
    "van_der_pol": (jm.van_der_pol, [[2.0], [1.0]]),
    "pendulum": (jm.pendulum, [[0.785398], [0.0]]),
    "logistic": (jm.logistic, [[0.1]]),
    "exponential": (jm.exponential, [[1.0]]),
}
TABLEAUS = ("heun_euler", "bs32", "rkf45", "dopri65")
_CACHE: dict = {}


def _n(model):
    return int(np.size(MODELS[model][1]))


def _rig(model, tableau, L, dtype):
    """(JAX rig tuple, port rig); cached."""
    key = (model, tableau, L, dtype)
    if key in _CACHE:
        return _CACHE[key]
    jdt = getattr(jnp, dtype)
    factory, x0_raw = MODELS[model]
    m, h, n = factory(), 0.01, _n(model)
    sol = getattr(js, tableau)(h)
    x0 = jnp.asarray(x0_raw, jdt)
    gt = js.solve(sol, m, 0.0, x0, STEPS)
    idx = np.arange(EVERY, STEPS + 1, EVERY)
    ys = np.asarray(gt["x"], np.float64)[idx].reshape(len(idx), n)
    ys = ys + np.sqrt(0.1) * np.random.default_rng(0).standard_normal(ys.shape)
    h_mat = np.eye(n)[:L]
    obs = j_obs(h_mat, np.asarray(gt["t"])[idx], ys, 0.1, 0.0, h, STEPS, dtype=jdt)
    box = {k: (0.5 * float(v), 1.5 * float(v)) for k, v in m.params.items()}
    spec = j_spec(m.params, box, {k: True for k in m.params}, dtype=jdt)
    ekf = JEKF(disable_cov_update=True)
    state0 = ekf.init_state(0.0, x0, j_const_diag(n, 1e-6, jdt), obs.obs_dim)
    jrig = (m, sol, ekf, spec, obs, state0, STEPS)
    trig = rig_from_numpy(
        {
            "model": m.name,
            "params": {k: np.array(v) for k, v in m.params.items()},
            "tableau": tableau,
            "h": h,
            "num_steps": STEPS,
            "t0": 0.0,
            "disable_cov_update": True,
            "spec_keys": spec.keys,
            "spec_shapes": spec.shapes,
            "defaults": np.asarray(spec.defaults_flat),
            "mins": np.asarray(spec.mins_flat),
            "maxs": np.asarray(spec.maxs_flat),
            "opt_mask": np.ones(spec.num_full, bool),
            "x0": np.asarray(state0.x),
            "P0_sqrt": np.asarray(state0.P_sqrt),
            "H": np.asarray(obs.H),
            "R_sqrt": np.asarray(obs.R_sqrt),
            "q_sqrt": np.eye(n),
            "ys": np.asarray(obs.ys),
            "flags": np.asarray(obs.flags),
            "index_map": np.asarray(obs.index_map),
        },
        device="cpu",
        dtype=getattr(torch, dtype),
    )
    _CACHE[key] = (jrig, trig)
    return _CACHE[key]


def _points(k, seed=1):
    return np.random.default_rng(seed).uniform(0.1, 0.9, size=(LANES, k))


def _cotangent(seed=2):
    return np.random.default_rng(seed).uniform(0.5, 1.5, size=LANES)


def _plain(trig, dtype, p, gamma_sqrt, g=None):
    """The port's plain value [B], and with a cotangent ``g`` its gradient
    (dphys [K, B], dgamma summed over lanes)."""
    tdt = getattr(torch, dtype)
    cm = nll_kernel.build_chain_math(trig.model, trig.solver, trig.spec, trig.obs, trig.state0, trig.q_sqrt)
    phys = nll_kernel.physical_rows(trig.spec, tdt, torch.as_tensor(p))
    ys = trig.obs.ys[: cm.n_obs].to(tdt)
    vals = nll_kernel.nll_plain(cm, phys, ys, gamma_sqrt)
    assert vals.dtype == tdt and vals.shape == (LANES,)
    if g is None:
        return vals.numpy()
    dphys, dgamma = nll_kernel.nll_grad_plain(cm, phys, ys, gamma_sqrt, torch.as_tensor(g, dtype=tdt))
    return vals.numpy(), dphys.numpy(), float(dgamma)


def _jax_values(jrig, dtype, p, gamma_sqrt):
    """JAX's XLA make_nll over the lanes (gamma traced: one jit a rig)."""
    key = ("val", id(jrig))
    jdt = getattr(jnp, dtype)
    if key not in _CACHE:
        nll, q = j_make_nll(*jrig), jnp.eye(_n(jrig[0].name), dtype=jdt)
        _CACHE[key] = jax.jit(jax.vmap(lambda x, gs: nll(x, q, gs), in_axes=(0, None)))
    return np.asarray(_CACHE[key](jnp.asarray(p, jdt), jnp.asarray(gamma_sqrt, jdt)))


def _jax_grads(jrig, dtype, p, gamma_sqrt):
    """JAX's make_nll [B] and jax.grad of it [B, P + 1] (normalized point,
    then gamma^1/2); one jit a rig."""
    key = ("grad", id(jrig))
    jdt = getattr(jnp, dtype)
    if key not in _CACHE:
        nll, q = j_make_nll(*jrig), jnp.eye(_n(jrig[0].name), dtype=jdt)
        vg = jax.value_and_grad(lambda x, gs: nll(x, q, gs), argnums=(0, 1))
        _CACHE[key] = jax.jit(jax.vmap(vg, in_axes=(0, None)))
    vals, (dp, dg) = _CACHE[key](jnp.asarray(p, jdt), jnp.asarray(gamma_sqrt, jdt))
    return np.asarray(vals), np.concatenate([np.asarray(dp), np.asarray(dg)[:, None]], axis=1)


def check_values(model, tableau, L):
    """The float64 plain value against JAX's tiles and make_nll."""
    jrig, trig = _rig(model, tableau, L, "float64")
    p = _points(trig.spec.num_opt)
    tiles = j_tiles(*jrig, np.eye(_n(model)))
    for gamma_sqrt in (0.1, 0.0):
        got = _plain(trig, "float64", p, gamma_sqrt)
        with jax.disable_jit():
            ref_tiles = np.asarray(tiles(jnp.asarray(p), jnp.asarray(gamma_sqrt, jnp.float64)))
        np.testing.assert_allclose(got, ref_tiles, **TOL_VAL["float64"])
        np.testing.assert_allclose(got, _jax_values(jrig, "float64", p, gamma_sqrt), **TOL_VAL["float64"])


def check_gradient(model, tableau, L, dtype):
    """The plain value and gradient against JAX's make_nll and jax.grad."""
    jrig, trig = _rig(model, tableau, L, dtype)
    spec = jrig[3]
    width = np.asarray(spec.maxs_flat - spec.mins_flat, np.float64)
    p, g = _points(trig.spec.num_opt), _cotangent()
    for gamma_sqrt in (0.1, 0.0):
        vals, grads = _jax_grads(jrig, dtype, p, gamma_sqrt)
        got, dphys, dgamma = _plain(trig, dtype, p, gamma_sqrt, g)
        np.testing.assert_allclose(got, vals, **TOL_VAL[dtype])
        # d/dphys_k = (d/dp_k) / (hi_k - lo_k): every row is optimized
        k = dphys.shape[0]
        np.testing.assert_allclose(dphys, g[None, :] * grads[:, :k].T / width[:, None], **TOL_GRAD[dtype])
        want = float(np.sum(g * grads[:, k]))
        # at gamma = 0 the derivative in gamma^1/2 vanishes (gamma Q enters
        # squared): both sides are rounding there, held against the rows' scale
        atol = TOL_GRAD[dtype]["rtol"] * float(np.abs(dphys).max()) if gamma_sqrt == 0.0 else TOL_GRAD[dtype]["atol"]
        np.testing.assert_allclose(dgamma, want, rtol=TOL_GRAD[dtype]["rtol"], atol=atol)


@pytest.mark.parametrize("model,L", [(m, L) for m in MODELS for L in sorted({1, _n(m)})])
def test_plain_values_match_jax_tiles_and_make_nll(model, L):
    check_values(model, "rkf45", L)


@pytest.mark.parametrize("model,dtype", [(m, "float64") for m in MODELS if m != "lotka_volterra"]
                         + [("pendulum", "float32")])
def test_plain_gradient_matches_jax_grad_of_make_nll(model, dtype):
    check_gradient(model, "rkf45", 1, dtype)


@pytest.mark.parametrize("model", list(MODELS))
def test_supports_every_erk_tableau_on_the_tile_models(model):
    _, trig = _rig(model, "rkf45", 1, "float64")
    args = dict(model=trig.model, ekf=trig.ekf, obs=trig.obs)
    for tab in TABLEAUS + ("kvaerno3",):
        assert nll_kernel.supports(**args, solver=getattr(ts, tab)(0.01), grad=True)
    assert not nll_kernel.supports(trig.model, ts.rkf45(0.01), TEKF(disable_cov_update=False), trig.obs)


def _coverage_rigs():
    """Lorenz at L = 3 and L = 2, and HH reduced-4 at L = 1 and L = 2, on the
    Lorenz rig's grid."""
    _, trig = _rig("lorenz", "rkf45", 3, "float64")
    two = type(trig.obs)(trig.obs.H[:2], trig.obs.R_sqrt[:2, :2], trig.obs.ys[:, :2], trig.obs.flags,
                         trig.obs.index_map)
    eye4 = torch.eye(4, dtype=torch.float64)
    one = type(trig.obs)(eye4[:1], trig.obs.R_sqrt[:1, :1], trig.obs.ys[:, :1], trig.obs.flags, trig.obs.index_map)
    hh_two = type(trig.obs)(eye4[:2], trig.obs.R_sqrt[:2, :2], trig.obs.ys[:, :2], trig.obs.flags,
                            trig.obs.index_map)
    return trig, two, tm.hodgkin_huxley("reduced-4"), one, hh_two


def test_supports_lorenz_l2_and_hodgkin_huxley_under_erk():
    """Lorenz at L = 2 under every tableau and single-compartment HH under
    every explicit tableau (L = 1) are instantiated."""
    trig, two, hh, one, _ = _coverage_rigs()
    assert nll_kernel.supports(trig.model, trig.solver, trig.ekf, trig.obs, grad=True)
    for tab in TABLEAUS + ("kvaerno3",):
        assert nll_kernel.supports(trig.model, getattr(ts, tab)(0.01), trig.ekf, two, grad=True)
        assert nll_kernel.supports(hh, getattr(ts, tab)(0.01), trig.ekf, one, grad=True)


def test_supports_rejects_lorenz_l2_and_hodgkin_huxley_under_erk():
    """What the kernels still reject around those chains: Lorenz at L = 2
    with the covariance update on, HH with two observed rows under every
    tableau, and multi-compartment HH."""
    trig, two, hh, one, hh_two = _coverage_rigs()
    for tab in TABLEAUS + ("kvaerno3",):
        assert not nll_kernel.supports(trig.model, getattr(ts, tab)(0.01), TEKF(disable_cov_update=False), two)
        assert not nll_kernel.supports(hh, getattr(ts, tab)(0.01), trig.ekf, hh_two)
    mc = tm.multi_compartment_hodgkin_huxley("reduced-4", 2)
    assert not nll_kernel.supports(mc, ts.rkf45(0.01), trig.ekf, one)
    assert "L = 1" in nll_kernel.no_grad_kernel(hh.name, "rkf45", 4, 2)


def test_wrapper_runs_the_plain_versions_on_cpu_for_a_new_instantiation():
    _, trig = _rig("van_der_pol", "bs32", 2, "float64")
    fn = nll_kernel.make_nll_cuda(trig.model, trig.solver, trig.ekf, trig.spec, trig.obs, trig.state0,
                                  trig.num_steps, trig.q_sqrt)
    p = torch.as_tensor(_points(trig.spec.num_opt))
    before = dict(nll_kernel.launches)
    got = fn(p.clone().requires_grad_(True), 0.1)
    got.sum().backward()
    assert nll_kernel.launches == before  # only a CUDA launch counts
    assert torch.equal(got.detach(), nll_kernel.nll_plain(fn.cm, fn.physical(p), fn.ys, 0.1))
    assert fn.cm.model_name == "van_der_pol" and fn.cm.solver.name == "bs32"
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn.launch(fn.physical(p), 0.1)
