"""The port's trajectory drivers (``inference/filter_run.py``: make_ekf_run,
make_ekf_run_static) and the dataclass support of ``utils/scan.scan_save``
against the JAX package, on Lotka-Volterra and Lorenz (RKF45) with
observations made from a numpy seed.

Tolerances (float64): t, x, y_hat, S_sqrt at rtol 1e-9 (atol 1e-12). The
local-error estimate ``eps`` is a difference of O(1) stage sums (~1e-10 of
the state at these step sizes), which XLA's CPU code and PyTorch round
differently; ``eps`` and the covariance factor it drives, ``P_sqrt``, are
held at rtol 1e-9 with atol 1e-15 times the state's largest magnitude, the
rounding floor of that difference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.filters import SqrtEKF as JEKF
from ode_uncertainty_tpu.inference import empty_obs_model as j_empty
from ode_uncertainty_tpu.inference import make_ekf_run as j_make_ekf_run
from ode_uncertainty_tpu.inference import make_ekf_run_static as j_make_ekf_run_static
from ode_uncertainty_tpu.inference import make_obs_model as j_make_obs_model
from ode_uncertainty_tpu.ops import const_diag as j_const_diag
from ode_uncertainty_tpu_torch import models as tm
from ode_uncertainty_tpu_torch import solvers as ts
from ode_uncertainty_tpu_torch.filters import EKFState, SqrtEKF
from ode_uncertainty_tpu_torch.inference import empty_obs_model, make_ekf_run, make_ekf_run_static, make_obs_model
from ode_uncertainty_tpu_torch.ops import const_diag
from ode_uncertainty_tpu_torch.utils.scan import scan_save

TIGHT = ("t", "x", "y_hat", "S_sqrt")


def _hold(got, ref, fields):
    scale = float(np.abs(np.asarray(ref.x)).max())
    for f in fields:
        g, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert g.shape == r.shape, f
        if f in TIGHT:
            np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-12, err_msg=f)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-15 * scale, err_msg=f)


SYSTEMS = {
    "lotkavolterra": (tm.lotka_volterra, jm.lotka_volterra, [[1.0, 1.0]], 0.01),
    "lorenz": (tm.lorenz, jm.lorenz, [[1.0, 1.0, 1.0]], 0.01),
}


def _obs(system, steps, every, rows, seed):
    """Observations of the system's RKF45 solve every ``every`` steps plus
    N(0, 0.05) noise, for both packages."""
    tmk, _, x0, h = SYSTEMS[system]
    sol = ts.solve(ts.rkf45(h), tmk(), 0.0, torch.tensor(x0, dtype=torch.float64), steps)
    ts_y, xs = sol["t"].numpy()[::every], sol["x"].numpy()[::every]
    xs = xs + np.sqrt(0.05) * np.random.default_rng(seed).standard_normal(xs.shape)
    H = np.eye(len(x0[0]))[rows]
    tobs = make_obs_model(H, ts_y, xs, 0.05, 0.0, h, steps, dtype=torch.float64, device="cpu")
    jobs = j_make_obs_model(H, ts_y, xs, 0.05, 0.0, h, steps, dtype=jnp.float64)
    return tobs, jobs


@pytest.mark.parametrize("system,steps,every,rows", [
    ("lotkavolterra", 120, 5, [0]),
    ("lotkavolterra", 120, 1, [0, 1]),
    ("lorenz", 100, 10, [0, 2]),
])
@pytest.mark.parametrize("save_every", [1, 7])
def test_ekf_run_with_corrections_matches_jax(system, steps, every, rows, save_every):
    tmk, jmk, x0, h = SYSTEMS[system]
    tobs, jobs = _obs(system, steps, every, rows, seed=steps + every)
    n = len(x0[0])
    m, jmod = tmk(), jmk()
    ekf, jekf = SqrtEKF(), JEKF()
    q = 0.1 * np.eye(n)
    s0 = ekf.init_state(0.0, torch.tensor(x0, dtype=torch.float64), const_diag(n, 1e-3, torch.float64), len(rows))
    js0 = jekf.init_state(0.0, jnp.asarray(x0), j_const_diag(n, 1e-3), len(rows))
    with torch.no_grad():
        last, traj = make_ekf_run(ekf, ts.rkf45(h), m, steps, save_every)(
            s0, m.params, torch.as_tensor(q), torch.tensor(0.1, dtype=torch.float64), tobs)
    jlast, jtraj = j_make_ekf_run(jekf, js.rkf45(h), jmod, steps, save_every)(
        js0, jmod.params, jnp.asarray(q), jnp.asarray(0.1), jobs)
    fields = ("t", "x", "eps", "P_sqrt", "y_hat", "S_sqrt")
    _hold(traj, jtraj, fields)
    _hold(last, jlast, fields)
    assert traj.x.shape[0] == steps // save_every + 1


@pytest.mark.parametrize("sigma", [1e-6, 1e-2])
def test_ekf_run_static_matches_jax(sigma):
    tobs, jobs = _obs("lotkavolterra", 100, 4, [0], seed=7)
    m, jmod = tm.lotka_volterra(), jm.lotka_volterra()
    s0 = SqrtEKF().init_state(0.0, torch.tensor([[1.0, 1.0]], dtype=torch.float64),
                              const_diag(2, 1e-6, torch.float64), 1)
    js0 = JEKF().init_state(0.0, jnp.asarray([[1.0, 1.0]]), j_const_diag(2, 1e-6), 1)
    with torch.no_grad():
        _, traj = make_ekf_run_static(SqrtEKF(), ts.rkf45(0.01), m, 100)(
            s0, m.params, torch.tensor(sigma, dtype=torch.float64), tobs)
    _, jtraj = j_make_ekf_run_static(JEKF(), js.rkf45(0.01), jmod, 100)(js0, jmod.params, jnp.asarray(sigma), jobs)
    _hold(traj, jtraj, ("t", "x", "eps", "P_sqrt", "y_hat", "S_sqrt"))


def test_reverse_and_forward_linearization_agree_over_a_run():
    """The drivers run without autograd (reverse-mode linearization); the
    same run with autograd recording takes the forward-mode route. Both
    compute the same Jacobian products, to rounding."""
    m, sol = tm.lorenz(), ts.rkf45(0.01)
    obs = empty_obs_model(3, 200, dtype=torch.float64, device="cpu")
    s0 = SqrtEKF().init_state(0.0, torch.tensor([[1.0, 1.0, 1.0]], dtype=torch.float64),
                              const_diag(3, 1e-3, torch.float64), 3)
    zq, zg = torch.zeros(3, 3, dtype=torch.float64), torch.zeros((), dtype=torch.float64)
    run = make_ekf_run(SqrtEKF(), sol, m, 200)
    with torch.no_grad():
        _, rev = run(s0, m.params, zq, zg, obs)
    with torch.enable_grad():
        _, fwd = run(s0, m.params, zq, zg, obs)
    torch.testing.assert_close(rev.x, fwd.x, rtol=0, atol=0)
    torch.testing.assert_close(rev.P_sqrt, fwd.P_sqrt, rtol=1e-9, atol=1e-15 * float(rev.x.abs().max()))


def test_ekf_run_over_a_batch_matches_single_runs():
    """tests/test_filters.py:199 on the port: the drivers take states with a
    leading batch dim (the JAX package vmaps the run)."""
    m, sol = tm.lotka_volterra(), ts.rkf45(0.02)
    obs = empty_obs_model(2, 25, dtype=torch.float64, device="cpu")
    x0s = torch.tensor([[[1.0, 1.0]], [[1.2, 0.8]], [[0.9, 1.4]]], dtype=torch.float64)
    p0 = const_diag(2, 1e-6, torch.float64)
    ekf = SqrtEKF(disable_cov_update=True)
    run = make_ekf_run(ekf, sol, m, 25)
    zq, zg = torch.zeros(2, 2, dtype=torch.float64), torch.zeros((), dtype=torch.float64)
    with torch.no_grad():
        _, trajs = run(ekf.init_state(0.0, x0s, p0.expand(3, 2, 2), 2), m.params, zq, zg, obs)
        single = run(ekf.init_state(0.0, x0s[1], p0, 2), m.params, zq, zg, obs)[1]
    assert trajs.x.shape == (26, 3, 1, 2)
    torch.testing.assert_close(trajs.x[:, 1], single.x, rtol=1e-12, atol=0)
    jrun = j_make_ekf_run(JEKF(disable_cov_update=True), js.rkf45(0.02), jm.lotka_volterra(), 25)
    _, jtraj = jrun(JEKF().init_state(0.0, jnp.asarray(x0s[1].numpy()), j_const_diag(2, 1e-6), 2),
                    jm.lotka_volterra().params, jnp.zeros((2, 2)), jnp.asarray(0.0), j_empty(2, 25))
    np.testing.assert_allclose(trajs.x[:, 1].numpy(), np.asarray(jtraj.x), rtol=1e-9)


def test_scan_save_stacks_dataclass_states():
    s0 = EKFState(t=torch.zeros(()), x=torch.zeros(1, 2), eps=torch.zeros(1, 2), P_sqrt=torch.eye(2),
                  y_hat=torch.zeros(1), S_sqrt=torch.zeros(1, 1))
    step = lambda s, i: s.replace(t=s.t + 1, x=s.x + i)
    last, traj = scan_save(step, s0, 10, 3)
    assert isinstance(traj, EKFState) and traj.x.shape == (4, 1, 2) and traj.P_sqrt.shape == (4, 2, 2)
    assert traj.t.tolist() == [0, 3, 6, 9] and float(last.t) == 9  # the partial last chunk is not run
    assert traj.x[:, 0, 0].tolist() == [0, 3, 15, 36]
