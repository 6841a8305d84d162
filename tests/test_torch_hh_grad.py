"""The gradient of the Kvaerno3 plain version of the NLL kernels
(``nll_grad_plain`` through ``ChainMath._kvaerno3_step``'s stage-solve rule)
against ``jax.grad`` of the JAX package's XLA ``make_nll`` (through the
stage solve's ``custom_jvp``, never the Newton loop) on Hodgkin-Huxley
reduced-4 with g_Na and g_K optimized, and the gradient wrapper's direction
list.

The rig crosses the stimulus onset: t0 = 9.9 from the rest state, 40 steps,
V observed after each; the port runs the XLA path's time rule
(``accumulate_time``). d NLL / d p_norm and d NLL / d gamma^1/2 agree at
float64 rtol 1e-9 (at gamma = 0 both give 0 for gamma^1/2). The tiles'
reference is tests/test_torch_hh_grad_tiles.py. Rigs and points from
tests/test_torch_hh_nll.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu.inference import make_nll as j_make_nll
from ode_uncertainty_tpu_torch.ops import nll_kernel
from test_torch_hh_nll import TOL, hh_rigs, points, port_args

_JIT: dict = {}


def jax_make_nll_grads(p, gamma_sqrt):
    """XLA make_nll [B] and its gradients [B, P + 1] in the normalized point
    and gamma^1/2 on the onset rig (one jit; gamma is traced)."""
    if "vg" not in _JIT:
        jrig = hh_rigs("reduced-4", "float64", 9.9, 40)[0]
        nll, q = j_make_nll(*jrig), jnp.eye(jrig[0].dim)
        vg = jax.value_and_grad(lambda x, g: nll(x, q, g), argnums=(0, 1))
        _JIT["vg"] = jax.jit(jax.vmap(vg, in_axes=(0, None)))
    vals, (dp, dg) = _JIT["vg"](jnp.asarray(p), jnp.asarray(gamma_sqrt, jnp.float64))
    return np.asarray(vals), np.concatenate([np.asarray(dp), np.asarray(dg)[:, None]], axis=1)


def jax_central_differences(jrig, p, gamma_sqrt, step):
    """XLA make_nll [B] at the normalized points p [B, P] and its central
    differences [B, P + 1] in each coordinate of p and in gamma^1/2, with
    ``step`` in every coordinate: one jit, vmapped over the points and
    their 2 (P + 1) neighbours (a rig where jax.grad of make_nll takes
    minutes to compile)."""
    nll, q = j_make_nll(*jrig), jnp.eye(jrig[0].dim)
    f = jax.jit(jax.vmap(lambda x, g: nll(x, q, g)))
    b, dim = p.shape
    shifts = np.concatenate([np.zeros((1, dim + 1)), step * np.eye(dim + 1), -step * np.eye(dim + 1)])
    xs = np.concatenate([p + s[:dim] for s in shifts])
    gs = np.concatenate([np.full(b, gamma_sqrt + s[dim]) for s in shifts])
    vals = np.asarray(f(jnp.asarray(xs), jnp.asarray(gs))).reshape(len(shifts), b)
    plus, minus = vals[1 : dim + 2], vals[dim + 2 :]
    return vals[0], ((plus - minus) / (2.0 * step)).T


def port_grads(trig, p, gamma_sqrt, accumulate_time):
    """The plain gradient pulled back to the normalized point: (NLL [B],
    d/d p_norm [B, P], d/d gamma^1/2 [B]) with a unit cotangent per lane."""
    cm = nll_kernel.build_chain_math(trig.model, trig.solver, trig.spec, trig.obs, trig.state0, trig.q_sqrt,
                                     accumulate_time)
    phys = nll_kernel.physical_rows(trig.spec, torch.float64, torch.as_tensor(p))
    ys = trig.obs.ys[: cm.n_obs].to(torch.float64)
    gs = torch.full((len(p),), gamma_sqrt, dtype=torch.float64)
    dphys, dgamma = nll_kernel.nll_grad_plain(cm, phys, ys, gs, torch.ones(len(p), dtype=torch.float64))
    idx = trig.spec.opt_indices
    width = (trig.spec.maxs_flat - trig.spec.mins_flat)[idx]
    vals = nll_kernel.nll_plain(cm, phys, ys, gamma_sqrt)
    return vals.numpy(), (dphys[idx].T * width).numpy(), dgamma.numpy()


def check(got, vals, grads):
    p_vals, p_dp, p_dg = got
    np.testing.assert_allclose(p_vals, vals, **TOL["float64"])
    np.testing.assert_allclose(p_dp, grads[:, :-1], **TOL["float64"])
    np.testing.assert_allclose(p_dg, grads[:, -1], **TOL["float64"])


@pytest.mark.parametrize("gamma_sqrt", [0.1, 0.0])
def test_grad_plain_matches_jax_make_nll_grad_across_the_onset(gamma_sqrt):
    _, trig = hh_rigs("reduced-4", "float64", 9.9, 40)
    p = points()
    vals, grads = jax_make_nll_grads(p, gamma_sqrt)
    assert np.isfinite(grads).all() and np.abs(grads[:, :-1]).min() > 0.0
    check(port_grads(trig, p, gamma_sqrt, accumulate_time=True), vals, grads)


def test_grad_rows_give_the_full_gradient_on_the_rows_asked_for():
    _, trig = hh_rigs("reduced-4", "float64", 9.98, 4)
    fn = nll_kernel.make_nll_cuda(*port_args(trig), trig.q_sqrt)
    p = torch.as_tensor(points(3, seed=5))
    phys, g = fn.physical(p), torch.tensor([0.5, 1.0, 1.5], dtype=torch.float64)
    full, dg_full = fn.grad(phys, 0.1, g)
    assert fn.opt_rows == tuple(trig.spec.opt_indices.tolist()) and len(fn.opt_rows) == 2
    part, dg_part = fn.grad(phys, 0.1, g, rows=fn.opt_rows)
    rows = list(fn.opt_rows)
    others = [r for r in range(fn.cm.k_params) if r not in rows]
    assert torch.equal(part[rows], full[rows]) and torch.equal(dg_part, dg_full)
    assert not part[others].any() and full[others].abs().sum() > 0
    # the autograd Function asks for the optimized rows only; its gradient in
    # the normalized point is the same
    q = p.clone().requires_grad_(True)
    (fn(q, 0.1) * g).sum().backward()
    width = (trig.spec.maxs_flat - trig.spec.mins_flat)[trig.spec.opt_indices]
    np.testing.assert_allclose(q.grad.numpy(), (full[rows].T * width).numpy(), rtol=1e-12)


def test_qr_gradient_is_finite_at_a_zero_column():
    # a column that is exactly zero (float32 reaches it when the covariance
    # underflows at gamma = 0): the reflection is skipped, and so is the
    # square root's 0/0 derivative
    x = torch.tensor([3.0, 4.0], dtype=torch.float64, requires_grad=True)
    zero = torch.zeros((), dtype=torch.float64)
    r = nll_kernel._qr_r_lists([[x[0], zero], [x[1], zero], [zero, zero]], eps=1e-30)
    assert float(r[1][1]) == 0.0 and abs(float(r[0][0])) == 5.0
    (grad,) = torch.autograd.grad(sum(v for row in r for v in row), x)
    assert torch.isfinite(grad).all()
