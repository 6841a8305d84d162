"""Gradients of the PyTorch port's NLL against the JAX package: the plain
version of the nll_bwd kernel (``nll_grad_plain``), the CPU route of the
kernels' autograd Function and its wrappers, and the parameter-box members
the optimizer uses.

Two JAX references, on Lotka-Volterra rigs with all four parameters
optimized (so the normalized gradient gives every physical row) and both
states observed:

* the forward-mode JVP sweep over ``make_nll_tiles`` (``_jvp_grad`` of
  tests/test_pallas_ekf.py: one tangent per parameter and one for
  gamma^1/2; reverse mode through the tile program compiles for minutes on
  a CPU), at the shortest horizon that runs both interval kinds (4 steps,
  an observation every 2), since the tile program unrolls every step and
  its JVP takes ~10 s to compile even there;
* ``jax.grad`` of the XLA ``make_nll`` (as ``test_tiles_grad_matches_xla_fast_path``
  and ``test_tiles_gamma_gradient`` of tests/test_pallas_ekf.py) at
  ``_lv_rig``'s size: 40 steps, an observation every 5. At gamma = 0 the
  XLA predict skips the QR with gamma Q (sqrt_ekf.py:105-113) where the tile
  math sums it; both give the same covariance, so the gradients agree to
  rounding.

Observations and points come from numpy seeds. Tolerances: float64 rtol
1e-9; float32 rtol 5e-3 / atol 1e-4 for gradients and rtol 2e-4 / atol 1e-4
for values (those of tests/test_pallas_ekf.py:165, :182).
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
from ode_uncertainty_tpu_torch.inference import make_param_spec as t_spec
from ode_uncertainty_tpu_torch.ops import nll_kernel
from ode_uncertainty_tpu_torch.utils.carry import rig_from_numpy

TOL_GRAD = {"float64": dict(rtol=1e-9, atol=0.0), "float32": dict(rtol=5e-3, atol=1e-4)}
TOL_VAL = {"float64": dict(rtol=1e-9, atol=0.0), "float32": dict(rtol=2e-4, atol=1e-4)}
ALL = {"alpha": True, "beta": True, "gamma": True, "delta": True}
BOX = {k: (0.1, 5.0) for k in ("alpha", "beta", "gamma", "delta")}
_CACHE: dict = {}


def _rigs(dtype, num_steps=40, every=5):
    """(JAX tile NLL, JAX make_nll, JAX spec, port rig); cached."""
    key = (dtype, num_steps, every)
    if key in _CACHE:
        return _CACHE[key]
    jdt = getattr(jnp, dtype)
    m, h = jm.lotka_volterra(), 0.01
    sol = js.rkf45(h)
    x0 = jnp.array([[1.0, 1.0]], jdt)
    gt = js.solve(sol, m, 0.0, x0, num_steps)
    idx = np.arange(every, num_steps + 1, every)
    ys = np.asarray(gt["x"])[idx].reshape(len(idx), -1)
    ys = ys + np.sqrt(0.01) * np.random.default_rng(0).standard_normal(ys.shape)
    obs = j_obs(np.eye(2), np.asarray(gt["t"])[idx], ys, 0.01, 0.0, h, num_steps, dtype=jdt)
    spec = j_spec(m.params, BOX, ALL, dtype=jdt)
    ekf = JEKF(disable_cov_update=True)
    state0 = ekf.init_state(0.0, x0, j_const_diag(2, 1e-6, jdt), obs.obs_dim)
    nll_t = j_tiles(m, sol, ekf, spec, obs, state0, num_steps, np.eye(2))
    nll_x = j_make_nll(m, sol, ekf, spec, obs, state0, num_steps)
    trig = rig_from_numpy(
        {
            "model": m.name,
            "params": {k: np.array(v) for k, v in m.params.items()},
            "tableau": sol.tableau.name,
            "h": h,
            "num_steps": num_steps,
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
            "q_sqrt": np.eye(2),
            "ys": np.asarray(obs.ys),
            "flags": np.asarray(obs.flags),
            "index_map": np.asarray(obs.index_map),
        },
        device="cpu",
        dtype=getattr(torch, dtype),
    )
    _CACHE[key] = (nll_t, nll_x, spec, trig)
    return _CACHE[key]


def _jax_tile_jvps(p, gamma_sqrt):
    """Float64 tile NLL [B] and its derivatives [B, P + 1] along each
    normalized column and gamma^1/2: one batched JVP pass per direction."""
    nll_t = _rigs("float64", 4, 2)[0]
    p0, g0 = jnp.asarray(p), jnp.asarray(gamma_sqrt, jnp.float64)
    cols = []
    for k in range(p0.shape[1]):
        tan = jnp.zeros_like(p0).at[:, k].set(1.0)
        vals, dv = jax.jvp(lambda q: nll_t(q, g0), (p0,), (tan,))
        cols.append(dv)
    _, dv = jax.jvp(lambda g: nll_t(p0, g), (g0,), (jnp.asarray(1.0, jnp.float64),))
    return np.asarray(vals), np.asarray(jnp.stack(cols + [dv], axis=1))


def _jax_xla_grads(dtype, p, gamma_sqrt):
    """XLA make_nll [B] and its gradients [B, P + 1] with respect to the
    normalized point and gamma^1/2 (one jit per dtype; gamma is traced)."""
    key = ("vg", dtype)
    if key not in _CACHE:
        nll_x = _rigs(dtype)[1]
        q = jnp.eye(2, dtype=getattr(jnp, dtype))
        vg = jax.value_and_grad(lambda x, g: nll_x(x, q, g), argnums=(0, 1))
        _CACHE[key] = jax.jit(jax.vmap(vg, in_axes=(0, None)))
    jdt = getattr(jnp, dtype)
    vals, (dp, dg) = _CACHE[key](jnp.asarray(p, jdt), jnp.asarray(gamma_sqrt, jdt))
    return np.asarray(vals), np.concatenate([np.asarray(dp), np.asarray(dg)[:, None]], axis=1)


def _points(n=6, seed=1):
    return np.random.default_rng(seed).uniform(0.1, 0.9, size=(n, 4))


def _cotangent(n=6, seed=2):
    return np.random.default_rng(seed).uniform(0.5, 1.5, size=n)


def _port_grads(dtype, p, g, gamma_sqrt, num_steps=40, every=5):
    """The port's plain gradient: (NLL [B], dphys [K, B], dgamma)."""
    trig = _rigs(dtype, num_steps, every)[3]
    tdt = getattr(torch, dtype)
    cm = nll_kernel.build_chain_math(trig.model, trig.solver, trig.spec, trig.obs, trig.state0, trig.q_sqrt)
    phys = nll_kernel.physical_rows(trig.spec, tdt, torch.as_tensor(p))
    ys = trig.obs.ys[: cm.n_obs].to(tdt)
    dphys, dgamma = nll_kernel.nll_grad_plain(cm, phys, ys, gamma_sqrt, torch.as_tensor(g, dtype=tdt))
    assert dphys.shape == (4, len(p)) and dgamma.shape == () and dphys.dtype == tdt
    return nll_kernel.nll_plain(cm, phys, ys, gamma_sqrt).numpy(), dphys.numpy(), float(dgamma)


def _check(dtype, spec, p_vals, p_dphys, p_dgamma, vals, grads, g):
    # d/dphys_k = (d/dp_k) / (hi_k - lo_k); the spec's rows are its sorted keys
    width = np.asarray(spec.maxs_flat - spec.mins_flat)
    np.testing.assert_allclose(p_dphys, g[None, :] * grads[:, :4].T / width[:, None], **TOL_GRAD[dtype])
    np.testing.assert_allclose(p_dgamma, float(np.sum(g * grads[:, 4])), **TOL_GRAD[dtype])
    np.testing.assert_allclose(p_vals, vals, **TOL_VAL[dtype])


@pytest.mark.parametrize("gamma_sqrt", [0.1, 0.0])
def test_grad_plain_matches_jax_tile_jvps(gamma_sqrt):
    p, g = _points(), _cotangent()
    vals, jvps = _jax_tile_jvps(p, gamma_sqrt)
    spec = _rigs("float64", 4, 2)[2]
    _check("float64", spec, *_port_grads("float64", p, g, gamma_sqrt, 4, 2), vals, jvps, g)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("gamma_sqrt", [0.1, 0.0])
def test_grad_plain_matches_jax_make_nll_grad(dtype, gamma_sqrt):
    p, g = _points(), _cotangent()
    vals, grads = _jax_xla_grads(dtype, p, gamma_sqrt)
    _check(dtype, _rigs(dtype)[2], *_port_grads(dtype, p, g, gamma_sqrt), vals, grads, g)


def test_grad_plain_gives_each_lanes_gamma_share():
    trig = _rigs("float64")[3]
    fn = nll_kernel.make_nll_cuda(trig.model, trig.solver, trig.ekf, trig.spec, trig.obs,
                                  trig.state0, trig.num_steps, trig.q_sqrt)
    p, g = torch.as_tensor(_points()), torch.as_tensor(_cotangent())
    phys = fn.physical(p)
    gs = torch.tensor([0.1, 0.0, 0.3, 0.1, 0.0, 0.3], dtype=torch.float64)
    dphys, dgamma = nll_kernel.nll_grad_plain(fn.cm, phys, fn.ys, gs, g)
    assert dgamma.shape == (6,)
    for value in (0.1, 0.0, 0.3):
        lanes = (gs == value).nonzero()[:, 0]
        dp, dg = nll_kernel.nll_grad_plain(fn.cm, phys[:, lanes], fn.ys, value, g[lanes])
        np.testing.assert_allclose(dphys[:, lanes].numpy(), dp.numpy(), rtol=1e-12)
        np.testing.assert_allclose(float(dgamma[lanes].sum()), float(dg), rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("gamma_sqrt", [0.1, 0.0])
def test_autograd_function_cpu_route_matches_jax(dtype, gamma_sqrt):
    # the kernel wrapper as the optimizer calls it: normalized points in,
    # NLL out, gradients by backward through NllKernelFunction
    trig = _rigs(dtype)[3]
    tdt = getattr(torch, dtype)
    fn = nll_kernel.make_nll_cuda(trig.model, trig.solver, trig.ekf, trig.spec, trig.obs,
                                  trig.state0, trig.num_steps, trig.q_sqrt)
    p_np, g = _points(seed=3), _cotangent(seed=4)
    vals, jvps = _jax_xla_grads(dtype, p_np, gamma_sqrt)
    p = torch.as_tensor(p_np, dtype=tdt).requires_grad_(True)
    gs = torch.tensor(gamma_sqrt, dtype=tdt, requires_grad=True)
    before = dict(nll_kernel.launches)
    out = fn(p, gs)
    (out * torch.as_tensor(g, dtype=tdt)).sum().backward()
    assert nll_kernel.launches == before  # only CUDA launches count
    np.testing.assert_allclose(out.detach().numpy(), vals, **TOL_VAL[dtype])
    np.testing.assert_allclose(p.grad.numpy(), g[:, None] * jvps[:, :4], **TOL_GRAD[dtype])
    np.testing.assert_allclose(float(gs.grad), float(np.sum(g * jvps[:, 4])), **TOL_GRAD[dtype])


def test_grad_finite_at_zero_gamma_float32():
    # the last tempering stage runs gamma = 0 exactly (test_pallas_ekf.py:186)
    trig = _rigs("float32")[3]
    fn = nll_kernel.make_nll_cuda(trig.model, trig.solver, trig.ekf, trig.spec, trig.obs,
                                  trig.state0, trig.num_steps, trig.q_sqrt)
    p = torch.as_tensor(np.random.default_rng(5).uniform(size=(16, 4)), dtype=torch.float32)
    dphys, dgamma = fn.grad(fn.physical(p), 0.0, torch.ones(16))
    assert torch.isfinite(dphys).all() and torch.isfinite(dgamma)


def test_grad_wrapper_routes_and_checks():
    trig = _rigs("float64")[3]
    fn = nll_kernel.make_nll_cuda(trig.model, trig.solver, trig.ekf, trig.spec, trig.obs,
                                  trig.state0, trig.num_steps, trig.q_sqrt)
    phys, g = fn.physical(torch.as_tensor(_points())), torch.as_tensor(_cotangent())
    dphys, dgamma = fn.grad(phys, 0.1, g)
    want_p, want_g = nll_kernel.nll_grad_plain(fn.cm, phys, fn.ys, 0.1, g)
    assert torch.equal(dphys, want_p) and torch.equal(dgamma, want_g)
    dphys2, none = fn.grad(phys, 0.1, g, with_dgamma=False)
    assert none is None and torch.equal(dphys2, dphys)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn.grad.launch(phys, 0.1, g)
    with pytest.raises(ValueError, match="no NLL kernel for device"):
        fn.grad(phys.to("meta"), 0.1, g.to("meta"))
    assert fn.grad.name == "nll_bwd" and set(nll_kernel.launches) == {"nll_fwd", "nll_bwd"}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_param_box_members_match_jax(dtype):
    m = jm.lotka_volterra()
    box = {k: (0.001, 5.0) for k in m.params}
    opt = {"alpha": True, "beta": False, "gamma": True, "delta": False}
    js_ = j_spec(m.params, box, opt, dtype=getattr(jnp, dtype))
    ts_ = t_spec({k: torch.as_tensor(np.asarray(v)) for k, v in m.params.items()}, box, opt,
                 dtype=getattr(torch, dtype), device="cpu")
    np.testing.assert_array_equal(ts_.defaults_norm_opt().numpy(), np.asarray(js_.defaults_norm_opt()))
    np.testing.assert_array_equal(ts_.opt_mask_full().numpy(), np.asarray(js_.opt_mask_full()))
    phys = np.array([[0.5, 2.0], [4.0, 0.01]])
    np.testing.assert_allclose(ts_.physical_to_opt(torch.as_tensor(phys, dtype=getattr(torch, dtype))).numpy(),
                               np.asarray(js_.physical_to_opt(jnp.asarray(phys, getattr(jnp, dtype)))),
                               **TOL_VAL[dtype])
