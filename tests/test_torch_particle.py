"""The port's particle (perturbation) filter against the JAX package.

Particle 0 is noise-free, so it is held bit for bit against the port's own
solve (``make_solve_fn``) and at float64 rtol 1e-9 against the JAX
package's particle 0. The other particles come from a ``torch.Generator``
(the JAX package threads a PRNG key; the draws never coincide), so they are
held by statistics: after one step from a common state, the perturbations
of M = 20,000 particles (generator seed 0) have a sample mean within 5
standard errors of 0 and a sample covariance within 5 standard errors of
the covariance update at the particles' ``eps``; over a 50-step run of 400
particles the port's ensemble variance of each coordinate and the JAX
package's (key 0) agree within 5 standard errors of their difference
(a variance estimate from M draws has a relative standard error of
sqrt(2 / (M - 1))).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.filters import DiagonalUpdate as JDiag
from ode_uncertainty_tpu.filters import OuterUpdate as JOuter
from ode_uncertainty_tpu.filters import ParticleFilter as JPF
from ode_uncertainty_tpu.filters import StaticDiagonalUpdate as JStatic
from ode_uncertainty_tpu.inference import make_pf_run as j_make_pf_run
from ode_uncertainty_tpu_torch import models as tm
from ode_uncertainty_tpu_torch import solvers as ts
from ode_uncertainty_tpu_torch.filters import DiagonalUpdate, OuterUpdate, ParticleFilter, StaticDiagonalUpdate
from ode_uncertainty_tpu_torch.inference import make_pf_run

N_SE = 5.0
X0 = [[1.0, 1.0, 1.0]]


def _one_step_noise(update, draws=20_000, static=False):
    """Perturbations of one step from a common state: (noise [M-1, n], eps of
    the step [n])."""
    m, sol = tm.lorenz(), ts.rkf45(0.05)
    pf = ParticleFilter(cov_update=update, num_particles=draws)
    s0 = pf.init_state(0.0, torch.tensor(X0, dtype=torch.float64))
    gen = torch.Generator().manual_seed(0)
    if static:
        out = pf.make_predict_static(sol, m.rhs, update)(s0, m.params, 0.3, gen)
    else:
        out = pf.make_predict(sol, m.rhs)(s0, m.params, gen)
    x_det, eps = sol.step(m.rhs, m.params, torch.zeros((), dtype=torch.float64), s0.x[:1])
    torch.testing.assert_close(out.x[0], x_det[0], rtol=0, atol=0)  # particle 0: no noise
    return (out.x[1:] - x_det).reshape(draws - 1, -1).numpy(), eps.reshape(-1)


@pytest.mark.parametrize("kind", ["diagonal", "outer", "static"])
def test_one_step_perturbations_match_the_covariance_update(kind):
    update = {"diagonal": DiagonalUpdate(scale=1e6), "outer": OuterUpdate(scale=1e6),
              "static": StaticDiagonalUpdate()}[kind]
    noise, eps = _one_step_noise(update, static=kind == "static")
    zero = torch.zeros(3, 3, dtype=torch.float64)
    want = (update.apply(0.3, zero, eps) if kind == "static" else update.apply(zero, eps)).numpy()
    n = noise.shape[0]
    d = np.diag(want)
    assert np.all(np.abs(noise.mean(0)) <= N_SE * np.sqrt(d / n) + 1e-300)
    cov_se = np.sqrt((np.outer(d, d) + want**2) / n)
    assert np.all(np.abs(np.cov(noise.T) - want) <= N_SE * cov_se + 1e-300), (np.cov(noise.T), want)
    if kind == "outer":  # a rank-1 draw: every perturbation is parallel to eps
        cross = noise[:, 0] * eps[1].item() - noise[:, 1] * eps[0].item()
        np.testing.assert_allclose(cross, 0.0, atol=1e-12 * np.abs(noise).max())


def test_particle0_is_deterministic_and_matches_jax():
    """tests/test_filters.py:170 on the port: particle 0 equals the port's
    solve bit for bit and the JAX package's particle 0 at rtol 1e-9."""
    m, sol = tm.lorenz(), ts.rkf45(0.01)
    pf = ParticleFilter(num_particles=16)
    x0 = torch.tensor(X0, dtype=torch.float64)
    _, traj = make_pf_run(pf, sol, m, 50)(pf.init_state(0.0, x0), m.params, torch.Generator().manual_seed(3))
    det = ts.solve(sol, m, 0.0, x0, 50)
    torch.testing.assert_close(traj.x[:, 0], det["x"], rtol=0, atol=0)
    assert float(traj.x[-1].std(0).max()) > 0  # the others spread out
    jpf = JPF(num_particles=16)
    _, jtraj = j_make_pf_run(jpf, js.rkf45(0.01), jm.lorenz(), 50)(
        jpf.init_state(0.0, jnp.asarray(X0), random.key(3)), jm.lorenz().params)
    np.testing.assert_allclose(traj.x[:, 0].numpy(), np.asarray(jtraj.x[:, 0]), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(traj.t.numpy(), np.asarray(jtraj.t), rtol=1e-12)
    assert traj.x.shape == tuple(jtraj.x.shape) and traj.eps.shape == tuple(jtraj.eps.shape)


def test_reproducible_with_its_seed_and_the_generator_advances():
    """tests/test_filters.py:186 on the port."""
    m, sol = tm.lotka_volterra(), ts.rkf45(0.01)
    pf = ParticleFilter(num_particles=8)
    s0 = pf.init_state(0.0, torch.tensor([[1.0, 1.0]], dtype=torch.float64))
    run = make_pf_run(pf, sol, m, 20)
    _, t1 = run(s0, m.params, torch.Generator().manual_seed(0))
    _, t2 = run(s0, m.params, torch.Generator().manual_seed(0))
    torch.testing.assert_close(t1.x, t2.x, rtol=0, atol=0)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    run(s0, m.params, gen)
    assert not torch.equal(gen.get_state(), state)
    # each step draws anew: the increments of particle 1 differ step to step
    steps = t1.x[1:, 1] - t1.x[:-1, 1]
    assert not torch.equal(steps[0], steps[1])


@pytest.mark.parametrize("kind", ["diagonal", "static"])
def test_ensemble_spread_matches_jax_statistically(kind):
    m, sol = tm.lorenz(), ts.rkf45(0.01)
    jmod, jsol = jm.lorenz(), js.rkf45(0.01)
    M, steps = 400, 50
    if kind == "diagonal":
        pf, jpf = ParticleFilter(DiagonalUpdate(scale=1e5), M), JPF(JDiag(scale=1e5), M)
        _, traj = make_pf_run(pf, sol, m, steps)(pf.init_state(0.0, torch.tensor(X0, dtype=torch.float64)),
                                                 m.params, torch.Generator().manual_seed(0))
        _, jtraj = j_make_pf_run(jpf, jsol, jmod, steps)(jpf.init_state(0.0, jnp.asarray(X0), random.key(0)),
                                                         jmod.params)
        xs, jxs = traj.x[-1, 1:].reshape(M - 1, -1).numpy(), np.asarray(jtraj.x[-1, 1:]).reshape(M - 1, -1)
    else:
        pf, jpf = ParticleFilter(num_particles=M), JPF(num_particles=M)
        pred = pf.make_predict_static(sol, m.rhs, StaticDiagonalUpdate())
        jpred = jpf.make_predict_static(jsol, jmod.rhs, JStatic())
        s = pf.init_state(0.0, torch.tensor(X0, dtype=torch.float64))
        js_ = jpf.init_state(0.0, jnp.asarray(X0), random.key(0))
        gen = torch.Generator().manual_seed(0)
        for _ in range(steps):
            s = pred(s, m.params, 1e-3, gen)
            js_ = jpred(js_, jmod.params, jnp.asarray(1e-3))
        xs, jxs = s.x[1:].reshape(M - 1, -1).numpy(), np.asarray(js_.x[1:]).reshape(M - 1, -1)
    v, jv = xs.var(0, ddof=1), jxs.var(0, ddof=1)
    se = np.sqrt(2.0 / (M - 2)) * np.sqrt(v**2 + jv**2)
    assert np.all(v > 0) and np.all(np.abs(v - jv) <= N_SE * se), (v, jv, se)
    np.testing.assert_allclose(xs.mean(0), jxs.mean(0), atol=N_SE * np.sqrt((v + jv) / (M - 1)).max())
