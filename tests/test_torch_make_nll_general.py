"""The rest of the port's ``make_nll`` against the JAX package's: the general
flag/index-map loop (an irregular grid, ``fast_path=False``), checkpointing
(``remat``, ``chunk_size``) and ``parameter_sensitivity``.

* The general path: value and gradient (in the normalized point and in
  gamma^1/2) on a Lotka-Volterra rig with one observation flag dropped (the
  grid is then irregular, so both packages take their general loops) and on
  the regular grid with ``fast_path=False``: float64 rtol 1e-9.
* Checkpointing changes memory, never values: the NLL and its gradient with
  a checkpoint per observation interval (``remat``), with chunks of the
  general path (``chunk_size``, the default chunks from 256 steps on) and
  with per-step checkpoints equal those without checkpoints within 1e-12
  relative to the largest, on Lotka-Volterra (RKF45) and on Hodgkin-Huxley
  reduced-4 (Kvaerno3: the stage-solve rule is recomputed in the backward
  pass).
* ``parameter_sensitivity``: value and gradient on Lotka-Volterra at rtol
  1e-9, the value on Hodgkin-Huxley reduced-4 (t0 = 9.9, 5 steps).

Rigs from tests/test_torch_nll.py (LV: 12 steps, an observation every 3)
and tests/test_torch_hh_nll.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu.inference import make_nll as j_make_nll
from ode_uncertainty_tpu_torch.inference import make_nll as t_make_nll
from test_torch_hh_nll import hh_rigs, points
from test_torch_nll import _points, _port_args, _rigs

TOL = dict(rtol=1e-9, atol=0.0)


def dropped_flag(jrig, trig):
    """Both rigs with the second observation's flag dropped (its row is left
    unread)."""
    jobs, tobs = jrig[4], trig.obs
    step = int(np.nonzero(np.asarray(jobs.flags))[0][1])
    jflags = np.asarray(jobs.flags).copy()
    jflags[step] = False
    tflags = tobs.flags.clone()
    tflags[step] = False
    jrig = (*jrig[:4], dataclasses.replace(jobs, flags=jnp.asarray(jflags)), *jrig[5:])
    return jrig, dataclasses.replace(trig, obs=dataclasses.replace(tobs, flags=tflags))


def jax_value_and_grads(jrig, p, gamma_sqrt, **kw):
    """JAX make_nll [B] and its gradients [B, P + 1] in the point and gamma^1/2."""
    nll, q = j_make_nll(*jrig, **kw), jnp.eye(jrig[0].dim)
    vg = jax.vmap(jax.value_and_grad(lambda x, g: nll(x, q, g), argnums=(0, 1)), in_axes=(0, None))
    vals, (dp, dg) = jax.jit(vg)(jnp.asarray(p), jnp.asarray(gamma_sqrt, jnp.float64))
    return np.asarray(vals), np.concatenate([np.asarray(dp), np.asarray(dg)[:, None]], axis=1)


def port_value_and_grads(trig, p, gamma_sqrt, **kw):
    """The port's make_nll [B] and its autograd gradients [B, P + 1]; the
    lanes are independent, so one backward pass of the sum gives each lane's
    gradient, and d/d gamma^1/2 comes from one gamma^1/2 per lane."""
    args = _port_args(trig)
    if "num_steps" in kw:
        args = (*args[:-1], kw.pop("num_steps"))
    nll = t_make_nll(*args, **kw)
    q = torch.as_tensor(p).clone().requires_grad_(True)
    g = torch.full((len(p), 1, 1), gamma_sqrt, dtype=torch.float64, requires_grad=True)
    vals = nll(q, trig.q_sqrt, g)
    vals.sum().backward()
    return vals.detach().numpy(), np.concatenate([q.grad.numpy(), g.grad[:, 0, 0].numpy()[:, None]], axis=1)


@pytest.mark.parametrize("gamma_sqrt", [0.1, 0.0])
@pytest.mark.parametrize("case", ["dropped_flag", "fast_path_off"])
def test_general_path_matches_jax(case, gamma_sqrt):
    jrig, trig = _rigs("float64", 2)
    kw = {}
    if case == "dropped_flag":
        jrig, trig = dropped_flag(jrig, trig)
    else:
        kw = {"fast_path": False}
    p = _points()
    vals, grads = jax_value_and_grads(jrig, p, gamma_sqrt, **kw)
    got_vals, got_grads = port_value_and_grads(trig, p, gamma_sqrt, **kw)
    assert np.isfinite(grads).all() and np.abs(grads[:, :2]).min() > 0.0
    np.testing.assert_allclose(got_vals, vals, **TOL)
    np.testing.assert_allclose(got_grads, grads, **TOL)


def assert_close_to_largest(got, ref, tol=1e-12):
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


CHECKPOINTING = [
    # (rig, options with checkpoints, options without)
    ("lv", {"remat": True}, {"chunk_size": 1}),
    ("lv", {"fast_path": False, "chunk_size": 4}, {"fast_path": False, "chunk_size": 1}),
    ("lv", {"fast_path": False, "remat": True, "chunk_size": 4}, {"fast_path": False, "chunk_size": 1}),
    ("lv", {"fast_path": False, "remat": True}, {"fast_path": False, "chunk_size": 1}),
    # a declared horizon of 300 steps: the defaults switch the per-interval
    # checkpoint and the general path's chunks of 17 steps on
    ("lv", {"num_steps": 300}, {"num_steps": 300, "chunk_size": 1}),
    ("lv", {"num_steps": 300, "fast_path": False}, {"num_steps": 300, "fast_path": False, "chunk_size": 1}),
    ("hh", {"remat": True}, {"chunk_size": 1}),
    ("hh", {"fast_path": False, "chunk_size": 2}, {"fast_path": False, "chunk_size": 1}),
]


@pytest.mark.parametrize("rig,with_ckpt,without", CHECKPOINTING)
def test_checkpointing_changes_no_value(rig, with_ckpt, without):
    if rig == "hh":
        trig, p = hh_rigs("reduced-4", "float64", 9.9, 5)[1], points(2)
    else:
        # 14 steps, an observation every 2: chunks of 4 leave a tail of 2
        trig, p = _rigs("float64", 2, num_steps=14, obs_every=2)[1], _points(3)
    got = port_value_and_grads(trig, p, 0.1, **with_ckpt)
    ref = port_value_and_grads(trig, p, 0.1, **without)
    for a, b in zip(got, ref):
        assert np.isfinite(b).all()
        assert_close_to_largest(a, b)


@pytest.mark.parametrize("gamma_sqrt", [0.1, 0.0])
def test_parameter_sensitivity_matches_jax_on_lv(gamma_sqrt):
    jrig, trig = _rigs("float64", 2)
    p = _points()
    vals, grads = jax_value_and_grads(jrig, p, gamma_sqrt, parameter_sensitivity=True)
    got_vals, got_grads = port_value_and_grads(trig, p, gamma_sqrt, parameter_sensitivity=True)
    plain_vals, _ = port_value_and_grads(trig, p, gamma_sqrt)
    if gamma_sqrt:
        assert np.abs(got_vals - plain_vals).min() > 1e-6  # the weights change the NLL
    np.testing.assert_allclose(got_vals, vals, **TOL)
    np.testing.assert_allclose(got_grads, grads, **TOL)


def test_parameter_sensitivity_value_matches_jax_on_hh():
    jrig, trig = hh_rigs("reduced-4", "float64", 9.9, 5)
    p = points(3)
    nll = j_make_nll(*jrig, parameter_sensitivity=True)
    q = jnp.eye(jrig[0].dim)
    ref = jax.jit(jax.vmap(lambda x: nll(x, q, jnp.asarray(0.1))))(jnp.asarray(p))
    got = t_make_nll(*_port_args(trig), parameter_sensitivity=True)(
        torch.as_tensor(p), trig.q_sqrt, torch.tensor(0.1, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
