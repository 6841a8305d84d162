"""The port's device L-BFGS (``inference/lbfgs.py``) against the JAX package's
``lbfgs_box`` (``vmap`` over the lanes), and its segments.

Tolerances (float64): ``x`` and ``f`` to 1e-10 absolute, ``g`` to 1e-8,
``iters``, ``n_fev`` and ``converged`` equal in every lane. The objectives
are written once in JAX and once in PyTorch (batched over a leading lane
axis) from the same numpy constants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu.inference.lbfgs import lbfgs_box as j_lbfgs
from ode_uncertainty_tpu.inference.lbfgs import lbfgs_box_init as j_init
from ode_uncertainty_tpu.inference.lbfgs import lbfgs_box_segment as j_segment
from ode_uncertainty_tpu.inference.lbfgs import lbfgs_result as j_result
from ode_uncertainty_tpu_torch.inference import LBFGSResult, lbfgs_box
from ode_uncertainty_tpu_torch.inference.lbfgs import lbfgs_box_init, lbfgs_box_segment, lbfgs_result, value_and_grad
from ode_uncertainty_tpu_torch.utils.carry import lbfgs_state_from_numpy

A = np.diag([1.0, 10.0, 100.0])
B = np.array([0.3, 0.4, 0.5])
TARGET = np.array([1.5, -0.2])


# name -> (JAX objective [P] -> [], port objective [B, P] -> [B], x0 [B, P], keywords)
CASES = {
    "quadratic": (
        lambda x: 0.5 * x @ jnp.asarray(A) @ x - jnp.asarray(B) @ x,
        lambda x: 0.5 * ((x @ torch.as_tensor(A)) * x).sum(-1) - (x * torch.as_tensor(B)).sum(-1),
        np.array([[0.9, 0.9, 0.9]]),
        dict(lower=0.0, upper=1.0, max_iter=100, tol=1e-8),
    ),
    "active_bound": (
        lambda x: jnp.sum((x - jnp.asarray(TARGET)) ** 2),
        lambda x: ((x - torch.as_tensor(TARGET)) ** 2).sum(-1),
        np.array([[0.5, 0.5]]),
        dict(lower=0.0, upper=1.0, max_iter=100, tol=1e-10),
    ),
    "rosenbrock": (
        lambda x: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2,
        lambda x: (1 - x[:, 0]) ** 2 + 100 * (x[:, 1] - x[:, 0] ** 2) ** 2,
        np.array([[0.1, 0.8]]),
        dict(lower=-2.0, upper=2.0, max_iter=400, tol=1e-10),
    ),
    "vmapped_16_lanes": (
        lambda x: jnp.sum((x - 0.3) ** 2) + jnp.sin(5 * x[0]) * 0.01,
        lambda x: ((x - 0.3) ** 2).sum(-1) + torch.sin(5 * x[:, 0]) * 0.01,
        np.random.default_rng(0).uniform(size=(16, 4)),
        dict(lower=0.0, upper=1.0, max_iter=100, tol=1e-8),
    ),
    # NaN regions act like line-search walls
    "nan_wall": (
        lambda x: jnp.where(x[0] > 0.9, jnp.nan, jnp.sum((x - 0.4) ** 2)),
        lambda x: torch.where(x[:, 0] > 0.9, torch.nan, ((x - 0.4) ** 2).sum(-1)),
        np.array([[0.5, 0.5]]),
        dict(lower=0.0, upper=1.0, max_iter=50),
    ),
}


def assert_same_result(got: LBFGSResult, ref) -> None:
    for field in ("x", "f"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(ref, field)), rtol=0, atol=1e-10,
                                   err_msg=field)
    np.testing.assert_allclose(got.g.numpy(), np.asarray(ref.g), rtol=0, atol=1e-8, err_msg="g")
    for field in ("iters", "n_fev", "converged"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(ref, field)), err_msg=field)


@pytest.mark.parametrize("case", list(CASES))
def test_lbfgs_box_matches_jax(case):
    fj, ft, x0, kw = CASES[case]
    ref = jax.vmap(lambda z: j_lbfgs(fj, z, **kw))(jnp.asarray(x0))
    got = lbfgs_box(ft, torch.tensor(x0), **kw)
    assert_same_result(got, ref)
    assert got.x.shape == x0.shape and got.iters.dtype == torch.int32
    assert np.isfinite(got.f.numpy()).all()


def test_lbfgs_box_reaches_the_reference_optima():
    # the reference's own checks on its five cases hold for the port
    sol = np.linalg.solve(A, B)
    for case, expect, atol in (("quadratic", sol, 1e-7), ("active_bound", [1.0, 0.0], 1e-8),
                               ("rosenbrock", [1.0, 1.0], 1e-5), ("nan_wall", [0.4, 0.4], 1e-5)):
        _, ft, x0, kw = CASES[case]
        res = lbfgs_box(ft, torch.tensor(x0), **kw)
        np.testing.assert_allclose(res.x.numpy()[0], expect, atol=atol, err_msg=case)
    _, ft, x0, kw = CASES["vmapped_16_lanes"]
    res = lbfgs_box(ft, torch.tensor(x0), **kw)
    np.testing.assert_allclose(res.f.numpy(), float(res.f[0]), rtol=1e-9)
    assert bool(res.converged.all())


def _segments(ft, x0, limits, **kw):
    lo, hi, tol = kw["lower"], kw["upper"], kw.get("tol", 1e-6)
    state = lbfgs_box_init(ft, torch.tensor(x0), lo, hi, 10, tol)
    for limit in limits:
        state = lbfgs_box_segment(ft, state, limit, lo, hi, tol=tol)
    return state


@pytest.mark.parametrize("case", ["rosenbrock", "vmapped_16_lanes"])
def test_segments_equal_one_call(case):
    _, ft, x0, kw = CASES[case]
    whole = _segments(ft, x0, [kw["max_iter"]], **kw)
    split = _segments(ft, x0, [1, 2, 3, 7, 20, kw["max_iter"]], **kw)
    for field in whole._fields:
        assert torch.equal(getattr(split, field), getattr(whole, field)), field
    # the result of the segmented run is the one-call result
    one_call = lbfgs_box(ft, torch.tensor(x0), **kw)
    for field in one_call._fields:
        assert torch.equal(getattr(lbfgs_result(split, kw["lower"], kw["upper"], kw["tol"]), field),
                           getattr(one_call, field)), field


def test_segment_resumes_from_a_jax_segment():
    fj, ft, x0, kw = CASES["vmapped_16_lanes"]
    lo, hi, tol = kw["lower"], kw["upper"], kw["tol"]
    x0 = x0[:8]

    def jax_state(limit):
        def one(z):
            st = j_init(fj, z, lo, hi, 10, tol)
            return j_segment(fj, st, limit, lo, hi, tol=tol)

        return jax.vmap(one)(jnp.asarray(x0))

    part = jax_state(3)
    assert int(np.min(np.asarray(part.iters))) == 3 and not np.asarray(part.done).all()
    state = lbfgs_state_from_numpy({f: np.asarray(getattr(part, f)) for f in part._fields}, device="cpu")
    got = lbfgs_box_segment(ft, state, kw["max_iter"], lo, hi, tol=tol)
    ref = jax_state(kw["max_iter"])
    assert_same_result(lbfgs_result(got, lo, hi, tol), jax.vmap(lambda s: j_result(s, lo, hi, tol))(ref))
    np.testing.assert_array_equal(got.stall.numpy(), np.asarray(ref.stall))
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(ref.done))


def test_a_trial_evaluates_only_the_lanes_still_searching():
    # a lane's evaluations are its own: widths of the objective's calls shrink
    # as lanes finish, and every lane's n_fev counts only its own trials
    _, ft, x0, kw = CASES["vmapped_16_lanes"]
    widths = []

    def counted(x):
        widths.append(x.shape[0])
        return ft(x)

    res = lbfgs_box(counted, torch.tensor(x0), **kw)
    assert widths[0] == 16 and min(widths) < 16
    assert sum(widths) == int(res.n_fev.sum())


def test_autograd_does_not_mix_lanes():
    # one lane's NaN never reaches another lane's gradient
    _, ft, x0, kw = CASES["nan_wall"]
    x = torch.tensor([[0.95, 0.5], [0.5, 0.5]], dtype=torch.float64)
    f, g = value_and_grad(ft, x)
    assert torch.isnan(f[0]) and torch.isfinite(f[1]) and torch.isfinite(g[1]).all()
    np.testing.assert_allclose(g[1].numpy(), [0.2, 0.2], atol=1e-15)
