"""The port's extension filters (dense EKF, UKF, square-root UKF,
Gaussian-mixture sqrt-EKF), the rank-1 Cholesky update's use in them and
the dense / GMM trajectory drivers, against the JAX package and against the
oracles of tests/test_extension_filters.py and tests/test_gmm_behavioral.py.

Tolerances (float64): values the two packages compute by the same
well-conditioned arithmetic, rtol 1e-9 (atol 1e-12); the oracle checks
keep the JAX tests' own tolerances. The GMM split direction is an
eigenvector, whose sign the JAX package leaves to its eigensolver and the
port fixes (largest entry positive): a split's two halves can sit in
swapped slots, so GMM states are compared slot-free, as the multiset of
(weight, mean, covariance) of the active components, and by the mixture
moments. Inputs from numpy seeds and the JAX tests' fixed values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.filters import UKF as JUKF
from ode_uncertainty_tpu.filters import DenseEKF as JDense
from ode_uncertainty_tpu.filters import GMMSqrtEKF as JGMM
from ode_uncertainty_tpu.filters import SqrtUKF as JSqrtUKF
from ode_uncertainty_tpu.inference import make_dense_run as j_make_dense_run
from ode_uncertainty_tpu.inference import make_gmm_run as j_make_gmm_run
from ode_uncertainty_tpu.inference import make_obs_model as j_make_obs_model
from ode_uncertainty_tpu.ops import const_diag as jcd
from ode_uncertainty_tpu_torch import models as tm
from ode_uncertainty_tpu_torch import solvers as ts
from ode_uncertainty_tpu_torch.filters import UKF, DenseEKF, DiagonalUpdate, GMMSqrtEKF, SqrtEKF, SqrtUKF
from ode_uncertainty_tpu_torch.filters.ukf import _ut_weights
from ode_uncertainty_tpu_torch.inference import make_dense_run, make_gmm_run, make_obs_model
from ode_uncertainty_tpu_torch.ops import const_diag

F64 = dict(rtol=1e-9, atol=1e-12)
D = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _lv_setup():
    """tests/test_extension_filters.py:_lv_setup in both packages."""
    return dict(
        x0=[[1.0, 2.0]], p0_sqrt=0.05, q=np.diag([0.01, 0.02]), y=[1.1], H=[[1.0, 0.0]], r_var=0.04, h=0.02,
    )


def _run(predict, correct, state, params, q, gamma, steps, obs_at=()):
    for k in range(steps):
        state = predict(state, params, q, gamma)
        for at, y, H, r in obs_at:
            if k == at:
                state = correct(state, H, y, r)
    return state


@pytest.mark.parametrize("kind", ["dense_ekf", "ukf", "sqrt_ukf"])
def test_filter_matches_jax(kind):
    s = _lv_setup()
    n = 2
    p0 = s["p0_sqrt"] * np.eye(n)
    r_sqrt = np.sqrt(s["r_var"]) * np.eye(1)
    m, jmod = tm.lotka_volterra(), jm.lotka_volterra()
    sol, jsol = ts.rkf45(s["h"]), js.rkf45(s["h"])
    if kind == "sqrt_ukf":
        flt, jflt, p_init, q, g, r = SqrtUKF(), JSqrtUKF(), p0, s["q"], 1.0, r_sqrt
    else:
        cls, jcls = {"dense_ekf": (DenseEKF, JDense), "ukf": (UKF, JUKF)}[kind]
        flt, jflt, p_init, q, g, r = cls(), jcls(), p0 @ p0.T, s["q"] @ s["q"].T, 1.0, r_sqrt @ r_sqrt.T
    state = flt.init_state(0.0, _t(s["x0"]), _t(p_init), 1)
    jstate = jflt.init_state(0.0, jnp.asarray(s["x0"]), jnp.asarray(p_init), 1)
    obs = [(9, _t(s["y"]), _t(s["H"]), _t(r)), (15, _t(s["y"]), _t(s["H"]), _t(r))]
    jobs = [(k, jnp.asarray(y.numpy()), jnp.asarray(H.numpy()), jnp.asarray(rr.numpy())) for k, y, H, rr in obs]
    got = _run(flt.make_predict(sol, m.rhs), flt.make_correct(), state, m.params, _t(q), torch.tensor(g, dtype=D),
               20, obs)
    ref = _run(jax.jit(jflt.make_predict(jsol, jmod.rhs)), jax.jit(jflt.make_correct()), jstate, jmod.params,
               jnp.asarray(q), jnp.asarray(g), 20, jobs)
    for f in [f.name for f in dataclasses.fields(got)]:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f, **F64)


def test_ut_weights_sum_to_one():
    w_m, w_c, scale = _ut_weights(4, 0.1, 2.0, 3.0 - 4, D)
    np.testing.assert_allclose(float(w_m.sum()), 1.0, rtol=1e-12)
    assert w_c[0] < 0 and float(scale) > 0  # the center weight is negative: a downdate


def test_dense_ekf_matches_sqrt_ekf():
    """tests/test_extension_filters.py:63 on the port."""
    s = _lv_setup()
    m, sol = tm.lotka_volterra(), ts.rkf45(s["h"])
    q_sqrt = _t(s["q"])
    y, H = _t(s["y"]), _t(s["H"])
    sq = SqrtEKF(disable_cov_update=True)
    s1 = sq.init_state(0.0, _t(s["x0"]), const_diag(2, 0.05, D), 1)
    s1 = _run(sq.make_predict(sol, m.rhs), sq.make_correct(), s1, m.params, q_sqrt, torch.tensor(1.0, dtype=D), 20,
              [(9, y, H, const_diag(1, s["r_var"] ** 0.5, D)), (15, y, H, const_diag(1, s["r_var"] ** 0.5, D))])
    de = DenseEKF(cov_update=DiagonalUpdate(scale=0.0))
    p0 = const_diag(2, 0.05, D)
    s2 = de.init_state(0.0, _t(s["x0"]), p0 @ p0.T, 1)
    s2 = _run(de.make_predict(sol, m.rhs), de.make_correct(), s2, m.params, q_sqrt @ q_sqrt.T,
              torch.tensor(1.0, dtype=D), 20,
              [(9, y, H, const_diag(1, s["r_var"], D)), (15, y, H, const_diag(1, s["r_var"], D))])
    np.testing.assert_allclose(s1.x.numpy(), s2.x.numpy(), rtol=1e-8)
    np.testing.assert_allclose((s1.P_sqrt @ s1.P_sqrt.T).numpy(), s2.P.numpy(), rtol=1e-7, atol=1e-12)


def test_ukf_matches_kf_on_linear_system():
    """tests/test_extension_filters.py:91 on the port: on a linear ODE the
    unscented transform is exact, UKF == EKF."""
    m, sol = tm.rlc_circuit(), ts.dopri65(0.05)
    x0 = torch.tensor([[1.0], [0.5]], dtype=D)
    p0 = const_diag(2, 0.1, D)
    q = torch.diag(torch.tensor([0.0004, 0.0009], dtype=D))
    g = torch.tensor(1.0, dtype=D)
    de, uk = DenseEKF(cov_update=DiagonalUpdate(scale=0.0)), UKF(cov_update=DiagonalUpdate(scale=0.0))
    se, su = de.init_state(0.0, x0, p0 @ p0.T, 1), uk.init_state(0.0, x0, p0 @ p0.T, 1)
    predd, predu = de.make_predict(sol, m.rhs), uk.make_predict(sol, m.rhs)
    for _ in range(15):
        se, su = predd(se, m.params, q, g), predu(su, m.params, q, g)
    np.testing.assert_allclose(su.x.numpy(), se.x.numpy(), rtol=1e-7)
    np.testing.assert_allclose(su.P.numpy(), se.P.numpy(), rtol=1e-5, atol=1e-12)


def test_sqrt_ukf_matches_dense_ukf():
    """tests/test_extension_filters.py:113 on the port."""
    s = _lv_setup()
    m, sol = tm.lotka_volterra(), ts.rkf45(s["h"])
    q_sqrt, y, H = _t(s["q"]), _t(s["y"]), _t(s["H"])
    p0 = const_diag(2, 0.05, D)
    uk, sq = UKF(), SqrtUKF()
    su, ss = uk.init_state(0.0, _t(s["x0"]), p0 @ p0.T, 1), sq.init_state(0.0, _t(s["x0"]), p0, 1)
    predu, corru, preds, corrs = uk.make_predict(sol, m.rhs), uk.make_correct(), sq.make_predict(sol, m.rhs), \
        sq.make_correct()
    one = torch.tensor(1.0, dtype=D)
    for k in range(12):
        su, ss = predu(su, m.params, q_sqrt @ q_sqrt.T, one), preds(ss, m.params, q_sqrt, one)
        if k == 7:
            su = corru(su, H, y, const_diag(1, s["r_var"], D))
            ss = corrs(ss, H, y, const_diag(1, s["r_var"] ** 0.5, D))
    np.testing.assert_allclose(ss.x.numpy(), su.x.numpy(), rtol=1e-6)
    np.testing.assert_allclose((ss.P_sqrt @ ss.P_sqrt.T).numpy(), su.P.numpy(), rtol=1e-5, atol=1e-12)


# ----------------------------------------------------------------- GMM

def _gmm_pair(**kw):
    return GMMSqrtEKF(**kw), JGMM(**kw)


def _components(state):
    """Active components as a sorted list of (weight, mean, covariance)."""
    act = np.asarray(state.active, bool)
    w = np.asarray(state.weights)[act]
    means = np.asarray(state.means)[act].reshape(act.sum(), -1)
    chol = np.asarray(state.P_sqrt)[act]
    covs = chol @ np.swapaxes(chol, -1, -2)
    order = np.lexsort(means.T[::-1])
    return w[order], means[order], covs[order]


def _hold_mixture(got, ref, rtol=1e-9, cov_atol=1e-12):
    assert int(got.active.sum()) == int(np.asarray(ref.active).sum())
    for a, b in zip(_components(got), _components(ref)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=cov_atol)
    mg, cg = GMMSqrtEKF.mixture_moments(got)
    mr, cr = JGMM.mixture_moments(ref)
    np.testing.assert_allclose(mg.numpy(), np.asarray(mr), rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(cg.numpy(), np.asarray(cr), rtol=rtol, atol=cov_atol)


def _bank(gmm, jgmm, x0, p0, slots):
    """Both packages' states with extra active components in ``slots``:
    (slot, mean, p_sqrt scale); weights given last."""
    *extra, weights = slots
    state, jstate = gmm.init_state(0.0, _t(x0), const_diag(len(x0[0]), p0, D)), \
        jgmm.init_state(0.0, jnp.asarray(x0), jcd(len(x0[0]), p0))
    means, chols, active = state.means.clone(), state.P_sqrt.clone(), state.active.clone()
    for slot, mean, scale in extra:
        means[slot] = _t(mean)
        chols[slot] = const_diag(len(x0[0]), scale, D)
        active[slot] = True
    w = _t(weights)
    state = state.replace(means=means, P_sqrt=chols, active=active, weights=w)
    jstate = jstate.replace(means=jnp.asarray(means.numpy()), P_sqrt=jnp.asarray(chols.numpy()),
                            active=jnp.asarray(active.numpy()), weights=jnp.asarray(w.numpy()))
    return state, jstate


def test_gmm_split_preserves_moments_and_matches_jax():
    """tests/test_extension_filters.py:138 on the port."""
    gmm, jgmm = _gmm_pair(max_components=4, nl_threshold=-1.0, merge_threshold=-1.0)
    state = gmm.init_state(0.0, torch.tensor([[1.0, 1.0, 1.0]], dtype=D), const_diag(3, 0.3, D))
    jstate = jgmm.init_state(0.0, jnp.asarray([[1.0, 1.0, 1.0]]), jcd(3, 0.3))
    nl = np.array([1.0, -np.inf, -np.inf, -np.inf])
    split = gmm._split_many(state, _t(nl))
    assert int(split.active.sum()) == 2
    mean, cov = GMMSqrtEKF.mixture_moments(split)
    np.testing.assert_allclose(mean.numpy(), [[1.0, 1.0, 1.0]], atol=1e-10)
    np.testing.assert_allclose(cov.numpy(), 0.09 * np.eye(3), rtol=1e-8, atol=1e-10)
    _hold_mixture(split, jgmm._split_many(jstate, jnp.asarray(nl)))


def test_gmm_merge_moment_matching_and_matches_jax():
    """tests/test_extension_filters.py:156 on the port."""
    gmm, jgmm = _gmm_pair(max_components=4, merge_threshold=1e9)
    state, jstate = _bank(gmm, jgmm, [[0.0, 0.0]], 0.5, [(1, [[1.0, 0.5]], 0.2), [0.6, 0.4, 0.0, 0.0]])
    before = GMMSqrtEKF.mixture_moments(state)
    merged = gmm._merge_pairs(state, exclude=torch.zeros(4, dtype=torch.bool))
    assert int(merged.active.sum()) == 1
    after = GMMSqrtEKF.mixture_moments(merged)
    np.testing.assert_allclose(after[0].numpy(), before[0].numpy(), atol=1e-10)
    np.testing.assert_allclose(after[1].numpy(), before[1].numpy(), rtol=1e-8)
    jmerged = jgmm._merge_pairs(jstate, exclude=jnp.zeros(4, bool))
    for f in ("means", "P_sqrt", "weights", "active"):
        np.testing.assert_allclose(getattr(merged, f).numpy(), np.asarray(getattr(jmerged, f)), **F64)


def test_gmm_multi_split_capacity_bounded():
    """tests/test_extension_filters.py:210 on the port."""
    gmm, jgmm = _gmm_pair(max_components=4, nl_threshold=0.0)
    state, jstate = _bank(gmm, jgmm, [[0.0, 0.0]], 0.5, [(1, [[3.0, 3.0]], 0.5), [0.5, 0.5, 0.0, 0.0]])
    nl = np.array([3.0, 2.0, 1.0, -np.inf])
    split = gmm._split_many(state, _t(nl))
    assert int(split.active.sum()) == 4
    np.testing.assert_allclose(float(split.weights.sum()), 1.0, rtol=1e-12)
    np.testing.assert_allclose(GMMSqrtEKF.mixture_moments(split)[0].numpy(),
                               GMMSqrtEKF.mixture_moments(state)[0].numpy(), atol=1e-10)
    _hold_mixture(split, jgmm._split_many(jstate, jnp.asarray(nl)))


def test_gmm_greedy_pairwise_merge():
    """tests/test_extension_filters.py:232 on the port: two close pairs merge
    in one pass."""
    gmm, jgmm = _gmm_pair(max_components=4, merge_threshold=10.0)
    state, jstate = _bank(gmm, jgmm, [[0.0, 0.0]], 0.3, [
        (1, [[0.1, 0.0]], 0.3), (2, [[50.0, 50.0]], 0.3), (3, [[50.1, 50.0]], 0.3), [0.25] * 4])
    merged = gmm._merge_pairs(state, exclude=torch.zeros(4, dtype=torch.bool))
    assert int(merged.active.sum()) == 2
    np.testing.assert_allclose(float(merged.weights.sum()), 1.0, rtol=1e-12)
    jmerged = jgmm._merge_pairs(jstate, exclude=jnp.zeros(4, bool))
    for f in ("means", "P_sqrt", "weights", "active"):
        np.testing.assert_allclose(getattr(merged, f).numpy(), np.asarray(getattr(jmerged, f)), **F64)


@pytest.mark.parametrize("case", ["distance", "min_weight"])
def test_gmm_invalidate_rules(case):
    """tests/test_extension_filters.py:252 and :269 on the port."""
    if case == "distance":
        gmm, jgmm = _gmm_pair(max_components=4, distance_threshold=10.0)
        slots = [(1, [[1.0, 0.0]], 0.3), (2, [[100.0, 0.0]], 0.3), [0.4, 0.4, 0.2, 0.0]]
        want = [True, True, False, False]
    else:
        gmm, jgmm = _gmm_pair(max_components=4, distance_threshold=1e9, min_weight=0.01)
        slots = [(1, [[1.0, 0.0]], 0.3), (2, [[2.0, 0.0]], 0.3), [0.6, 0.395, 0.005, 0.0]]
        want = [True, True, False, False]
    state, jstate = _bank(gmm, jgmm, [[0.0, 0.0]], 0.3, slots)
    out, jout = gmm._invalidate(state), jgmm._invalidate(jstate)
    np.testing.assert_array_equal(out.active.numpy(), want)
    np.testing.assert_allclose(float(out.weights.sum()), 1.0, rtol=1e-12)
    np.testing.assert_array_equal(out.active.numpy(), np.asarray(jout.active))
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(jout.weights), **F64)


def test_gmm_population_trace_matches_jax():
    """The setting of tests/test_gmm_behavioral.py:144 (Lorenz, K = 4, splits
    and merges within 40 steps): the port's predict step by step against the
    JAX package's, component population and mixture at every step."""
    kw = dict(max_components=4, nl_threshold=260.0, merge_threshold=2.0, split_displacement=0.5,
              distance_threshold=1e6, min_weight=0.01)
    gmm, jgmm = _gmm_pair(**kw)
    m, sol, jmod, jsol = tm.lorenz(), ts.rkf45(0.002), jm.lorenz(), js.rkf45(0.002)
    x0 = [[2.0, 1.0, 20.0]]
    state, jstate = gmm.init_state(0.0, _t(x0), const_diag(3, 0.3, D)), jgmm.init_state(0.0, jnp.asarray(x0), jcd(3, 0.3))
    pred, jpred = gmm.make_predict(sol, m.rhs), jax.jit(jgmm.make_predict(jsol, jmod.rhs))
    zq, zg = torch.zeros(3, 3, dtype=D), torch.zeros((), dtype=D)
    counts = []
    with torch.no_grad():
        for _ in range(40):
            state = pred(state, m.params, zq, zg)
            jstate = jpred(jstate, jmod.params, jnp.zeros((3, 3)), jnp.asarray(0.0))
            _hold_mixture(state, jstate, rtol=1e-8, cov_atol=1e-10)
            counts.append(int(state.active.sum()))
    assert max(counts) > 1 and len(set(counts)) > 1  # it split and merged


def _obs_pair(steps, every, h):
    sol = ts.solve(ts.rkf45(h), tm.lotka_volterra(), 0.0, torch.tensor([[1.0, 1.0]], dtype=D), steps)
    ts_y, xs = sol["t"].numpy()[::every], sol["x"].numpy()[::every]
    xs = xs + 0.2 * np.random.default_rng(11).standard_normal(xs.shape)
    args = (np.eye(2)[[0]], ts_y, xs, 0.04, 0.0, h, steps)
    return make_obs_model(*args, dtype=D, device="cpu"), j_make_obs_model(*args, dtype=jnp.float64)


@pytest.mark.parametrize("kind", ["dense_ekf", "ukf", "gmm"])
def test_trajectory_drivers_match_jax(kind):
    steps, h = 60, 0.02
    obs, jobs = _obs_pair(steps, 6, h)
    m, jmod, sol, jsol = tm.lotka_volterra(), jm.lotka_volterra(), ts.rkf45(h), js.rkf45(h)
    x0 = [[1.0, 1.0]]
    zq, zg = torch.zeros(2, 2, dtype=D), torch.zeros((), dtype=D)
    if kind == "gmm":
        kw = dict(max_components=4, nl_threshold=0.5, merge_threshold=0.05)
        flt, jflt = _gmm_pair(**kw)
        s0, js0 = flt.init_state(0.0, _t(x0), const_diag(2, 0.1, D)), jflt.init_state(0.0, jnp.asarray(x0), jcd(2, 0.1))
        make, jmake = make_gmm_run, j_make_gmm_run
    else:
        flt, jflt = (DenseEKF(), JDense()) if kind == "dense_ekf" else (UKF(), JUKF())
        p0 = 0.01 * np.eye(2)
        s0, js0 = flt.init_state(0.0, _t(x0), _t(p0), 1), jflt.init_state(0.0, jnp.asarray(x0), jnp.asarray(p0), 1)
        make, jmake = make_dense_run, j_make_dense_run
    with torch.no_grad():
        _, traj = make(flt, sol, m, steps, 2)(s0, m.params, zq, zg, obs)
    _, jtraj = jmake(jflt, jsol, jmod, steps, 2)(js0, jmod.params, jnp.zeros((2, 2)), jnp.asarray(0.0), jobs)
    if kind == "gmm":
        for i in range(traj.t.shape[0]):
            at = lambda tr: type(tr)(**{f: getattr(tr, f)[i] for f in ("t", "means", "P_sqrt", "eps", "weights",
                                                                         "active")})
            _hold_mixture(at(traj), at(jtraj), rtol=1e-8, cov_atol=1e-12)
        assert int(traj.active.sum(-1).max()) >= 2  # the bank adapted
    else:
        for f in ("t", "x", "P", "y_hat", "S"):
            np.testing.assert_allclose(getattr(traj, f).numpy(), np.asarray(getattr(jtraj, f)), err_msg=f, **F64)
        np.testing.assert_allclose(traj.eps.numpy(), np.asarray(jtraj.eps), rtol=1e-9, atol=1e-15)
