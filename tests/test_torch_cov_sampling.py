"""The port's covariance-update samplers, the static (Conrad) update and
predict, the rank-1 Cholesky update, the Gaussian helpers of
``ops/sqrt_linalg.py``, the reverse-mode linearization and the config
adapters, against the JAX package.

Inputs come from numpy seeds. Tolerances:
  * deterministic values, float64: rtol 1e-9 (atol 1e-12 where values cross
    zero);
  * samplers: the JAX package threads PRNG keys and the port
    ``torch.Generator``s, which never give the same draws, so each is held
    by statistics: over 40,000 draws (generator seed 0, key 0) the sample
    mean within 5 standard errors of 0 and every entry of the sample
    covariance within 5 standard errors of ``apply(0, eps)`` (the standard
    error of a covariance entry C_ij is sqrt((C_ii C_jj + C_ij^2) / N)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.filters import cov_updates as jcu
from ode_uncertainty_tpu.filters.sqrt_ekf import SqrtEKF as JEKF
from ode_uncertainty_tpu.inference import empty_obs_model as j_empty_obs_model
from ode_uncertainty_tpu.ops import sqrt_linalg as jsl
from ode_uncertainty_tpu.ops.chol_update import chol_update as j_chol_update
from ode_uncertainty_tpu.ops.linearize import push_sqrt as j_push_sqrt
from ode_uncertainty_tpu_torch import models as tm
from ode_uncertainty_tpu_torch import solvers as ts
from ode_uncertainty_tpu_torch.filters import cov_updates as tcu
from ode_uncertainty_tpu_torch.filters.sqrt_ekf import SqrtEKF as TEKF
from ode_uncertainty_tpu_torch.inference import empty_obs_model
from ode_uncertainty_tpu_torch.ops import sqrt_linalg as tsl
from ode_uncertainty_tpu_torch.ops.chol_update import chol_update
from ode_uncertainty_tpu_torch.ops.linearize import push_sqrt

F64 = dict(rtol=1e-9, atol=1e-12)
DRAWS = 40_000
N_SE = 5.0


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _chol(rng, n, batch=()):
    a = rng.standard_normal((*batch, n, n)) * 0.3
    return np.linalg.cholesky(a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(n))


def _hold_moments(draws: np.ndarray, want: np.ndarray):
    """Sample mean and covariance of ``draws`` [N, n] within N_SE standard
    errors of 0 and ``want``."""
    n_draws = draws.shape[0]
    mean_se = np.sqrt(np.diag(want) / n_draws)
    assert np.all(np.abs(draws.mean(0)) <= N_SE * mean_se + 1e-15), (draws.mean(0), mean_se)
    cov = np.cov(draws.T)
    d = np.diag(want)
    cov_se = np.sqrt((np.outer(d, d) + want**2) / n_draws)
    assert np.all(np.abs(cov - want) <= N_SE * cov_se + 1e-15), (cov, want, cov_se)


SAMPLERS = [
    ("DiagonalCovarianceUpdate", dict(scale=1.3), [0.5, 1.0, 0.25]),
    ("OuterCovarianceUpdate", dict(scale=0.8), [0.4, 0.2, 0.6]),
    ("StaticDiagonalCovarianceUpdate", dict(), [0.4, 0.2, 0.6]),
]


@pytest.mark.parametrize("name,kw,eps", SAMPLERS, ids=[s[0] for s in SAMPLERS])
def test_sampler_matches_covariance_like_jax(name, kw, eps):
    eps_np = np.asarray(eps)
    sigma = 0.7
    tu, ju = tcu.COV_UPDATE_REGISTRY[name](**kw), jcu.COV_UPDATE_REGISTRY[name](**kw)
    static = name.startswith("Static")
    gen = torch.Generator().manual_seed(0)
    eps_b = _t(np.broadcast_to(eps_np, (DRAWS, 3)).copy())
    draws = (tu.sample(sigma, gen, eps_b) if static else tu.sample(gen, eps_b)).numpy()
    zero = torch.zeros(3, 3, dtype=torch.float64)
    want = (tu.apply(sigma, zero, _t(eps_np)) if static else tu.apply(zero, _t(eps_np))).numpy()
    _hold_moments(draws, want)
    # the JAX sampler, held to the same covariance (its own apply, which the
    # port equals at rtol 1e-9)
    keys = random.split(random.key(0), DRAWS)
    if static:
        jdraws = jax.vmap(lambda k: ju.sample(jnp.asarray(sigma), k, jnp.asarray(eps_np)))(keys)
        jwant = ju.apply(jnp.asarray(sigma), jnp.zeros((3, 3)), jnp.asarray(eps_np))
    else:
        jdraws = jax.vmap(lambda k: ju.sample(k, jnp.asarray(eps_np)))(keys)
        jwant = ju.apply(jnp.zeros((3, 3)), jnp.asarray(eps_np))
    np.testing.assert_allclose(want, np.asarray(jwant), **F64)
    _hold_moments(np.asarray(jdraws), want)


def test_samplers_advance_the_generator_and_repeat_with_its_seed():
    u = tcu.DiagonalUpdate()
    eps = torch.ones(4, 3, dtype=torch.float64)
    gen = torch.Generator().manual_seed(5)
    a, b = u.sample(gen, eps), u.sample(gen, eps)
    assert not torch.equal(a, b)
    torch.testing.assert_close(u.sample(torch.Generator().manual_seed(5), eps), a, rtol=0, atol=0)


@pytest.mark.parametrize("sigma", [0.7, [0.1, 0.7, 2.0]], ids=["scalar", "per_lane"])
def test_static_update_matches_jax(sigma):
    rng = np.random.default_rng(1)
    chol = _chol(rng, 3, (3,))
    eps = np.abs(rng.standard_normal((3, 3)))
    sig = np.broadcast_to(np.asarray(sigma, float), (3,))
    tu, ju = tcu.StaticDiagonalUpdate(), jcu.StaticDiagonalUpdate()
    sig_t = torch.tensor(sigma, dtype=torch.float64)
    got_sqrt = tu.apply_sqrt(sig_t, _t(chol), _t(eps)).numpy()
    got = tu.apply(sig_t, _t(chol @ np.swapaxes(chol, -1, -2)), _t(eps)).numpy()
    for i in range(3):
        s = jnp.asarray(sig[i])
        np.testing.assert_allclose(got_sqrt[i], np.asarray(ju.apply_sqrt(s, jnp.asarray(chol[i]), jnp.asarray(eps[i]))),
                                   **F64)
        np.testing.assert_allclose(got[i], np.asarray(ju.apply(s, jnp.asarray(chol[i] @ chol[i].T),
                                                               jnp.asarray(eps[i]))), **F64)
        np.testing.assert_allclose(got_sqrt[i] @ got_sqrt[i].T, got[i], **F64)


@pytest.mark.parametrize("grad", [False, True], ids=["reverse_route", "forward_route"])
def test_predict_static_matches_jax(grad):
    rng = np.random.default_rng(2)
    x = rng.uniform(0.5, 1.5, (4, 1, 2))
    p = _chol(rng, 2, (4,)) * 0.1
    sigma = np.array([1e-3, 1e-2, 0.1, 1.0])
    tpred = TEKF().make_predict_static(ts.rkf45(0.05), tm.lotka_volterra().rhs)
    jmod = jm.lotka_volterra()
    jpred = JEKF().make_predict_static(js.rkf45(0.05), jmod.rhs)
    s = TEKF().init_state(0.0, _t(x), _t(p), 1)
    with torch.set_grad_enabled(grad):
        got = tpred(s, tm.lotka_volterra().params, _t(sigma))
    for i in range(4):
        ref = jpred(JEKF().init_state(0.0, jnp.asarray(x[i]), jnp.asarray(p[i]), 1), jmod.params, jnp.asarray(sigma[i]))
        for f in ("x", "P_sqrt", "t"):
            np.testing.assert_allclose(getattr(got, f)[i].numpy() if f != "t" else float(got.t),
                                       np.asarray(getattr(ref, f)), **F64)
        # the local-error estimate is a difference of O(1) stage sums: held
        # at 1e-15 of the state's scale, its rounding floor
        np.testing.assert_allclose(got.eps[i].numpy(), np.asarray(ref.eps), rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("n,batch", [(2, ()), (3, (4,)), (8, (2,))])
def test_push_sqrt_reverse_route_matches_forward_and_jax(n, batch):
    rng = np.random.default_rng(3)
    x = rng.uniform(0.5, 1.5, (*batch, n))
    p = _chol(rng, n, batch)
    a = rng.standard_normal((n, n)) * 0.5

    def f_t(z):
        return torch.sin(z @ torch.as_tensor(a).T) * z, z**2

    def f_j(z):
        return jnp.sin(jnp.asarray(a) @ z) * z, z**2

    (y_r, aux_r), jp_r = push_sqrt(f_t, _t(x), _t(p), reverse=True)
    (y_f, aux_f), jp_f = push_sqrt(f_t, _t(x), _t(p))
    torch.testing.assert_close(jp_r, jp_f, rtol=1e-12, atol=1e-14)
    # the primal runs on n copies of the batch: a product inside f may round
    # in another order
    torch.testing.assert_close(y_r, y_f, rtol=1e-14, atol=1e-15)
    torch.testing.assert_close(aux_r, aux_f, rtol=1e-14, atol=1e-15)
    xs, ps, jps = x.reshape(-1, n), p.reshape(-1, n, n), jp_r.numpy().reshape(-1, n, n)
    for i in range(xs.shape[0]):
        (yj, _), jpj = j_push_sqrt(f_j, jnp.asarray(xs[i]), jnp.asarray(ps[i]))
        np.testing.assert_allclose(jps[i], np.asarray(jpj), **F64)
        np.testing.assert_allclose(y_r.numpy().reshape(-1, n)[i], np.asarray(yj), **F64)


@pytest.mark.parametrize("mult", [0.7, -0.04, -1.0], ids=["update", "downdate", "downdate_to_indefinite"])
def test_chol_update_matches_jax_and_dense(mult):
    rng = np.random.default_rng(4)
    chol = _chol(rng, 5, (3,))
    v = rng.standard_normal((3, 5))
    if mult == -1.0:
        v = v * 10.0  # the downdate leaves the cone: NaN, as the JAX package gives
    got = chol_update(_t(chol), _t(v), mult).numpy()
    for i in range(3):
        ref = np.asarray(j_chol_update(jnp.asarray(chol[i]), jnp.asarray(v[i]), mult))
        np.testing.assert_array_equal(np.isnan(got[i]), np.isnan(ref))
        if mult == -1.0:
            assert np.isnan(got[i]).any()
            continue
        np.testing.assert_allclose(got[i], ref, **F64)
        dense = chol[i] @ chol[i].T + mult * np.outer(v[i], v[i])
        np.testing.assert_allclose(got[i] @ got[i].T, dense, rtol=1e-9, atol=1e-10)
        assert np.allclose(np.triu(got[i], 1), 0.0)
    # a per-lane multiplier equals the scalar one lane by lane
    per_lane = chol_update(_t(chol), _t(v), torch.tensor([mult] * 3, dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(np.isnan(per_lane), np.isnan(got))
    np.testing.assert_allclose(per_lane[~np.isnan(got)], got[~np.isnan(got)], rtol=0, atol=0)


@pytest.mark.parametrize("fn", ["tria", "pdf", "kl", "jeffrey"])
def test_gaussian_helpers_match_jax(fn):
    rng = np.random.default_rng(5)
    s1, s2 = _chol(rng, 3, (4,)), _chol(rng, 3, (4,))
    m1, m2 = rng.standard_normal((4, 3)), rng.standard_normal((4, 3))
    if fn == "tria":
        wide = rng.standard_normal((4, 3, 7))
        got = tsl.tria(_t(wide)).numpy()
        ref = np.stack([np.asarray(jsl.tria(jnp.asarray(w))) for w in wide])
    elif fn == "pdf":
        got = tsl.pdf_gaussian_sqrt(_t(m1), _t(m2), _t(s1)).numpy()
        ref = np.asarray(jsl.pdf_gaussian_sqrt(jnp.asarray(m1), jnp.asarray(m2), jnp.asarray(s1)))
    else:
        tfn = {"kl": tsl.kl_gaussian_sqrt, "jeffrey": tsl.jeffrey_gaussian_sqrt}[fn]
        jfn = {"kl": jsl.kl_gaussian_sqrt, "jeffrey": jsl.jeffrey_gaussian_sqrt}[fn]
        # [4, 1] x [1, 4] pairs broadcast, as the GMM merge calls it
        got = tfn(_t(m1)[:, None], _t(m2)[None], _t(s1)[:, None], _t(s2)[None]).numpy()
        ref = np.asarray(jfn(jnp.asarray(m1)[:, None], jnp.asarray(m2)[None], jnp.asarray(s1)[:, None],
                             jnp.asarray(s2)[None]))
    np.testing.assert_allclose(got, ref, **F64)


def test_empty_obs_model_matches_jax():
    got = empty_obs_model(3, 7, dtype=torch.float64, device="cpu")
    ref = j_empty_obs_model(3, 7, dtype=jnp.float64)
    for f in ("H", "R_sqrt", "ys", "flags", "index_map"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    assert got.obs_dim == 3 and not got.flags.any()


def test_adapters_keep_the_static_update_builder():
    """A config that sets static_cov_update_fn_builder: the SQRT_EKF and
    ParticleFilter adapters keep it on the filter (its scale drives
    run_filter's use_static_cov_fn branch), as the JAX package's do."""
    from ode_uncertainty_tpu.utils.config import instantiate as j_instantiate
    from ode_uncertainty_tpu_torch.filters import ParticleFilter, SqrtEKF, StaticDiagonalUpdate
    from ode_uncertainty_tpu_torch.utils.config import instantiate

    static = {"class_path": "src.covariance_update_functions.StaticDiagonalCovarianceUpdate",
              "init_args": {"scale": 0.25}}
    for kind, cls in (("SQRT_EKF", SqrtEKF), ("ParticleFilter", ParticleFilter)):
        node = {"class_path": f"src.filters.{kind}",
                "init_args": {"cov_update_fn_builder": {"class_path": "DiagonalCovarianceUpdate",
                                                        "init_args": {"scale": 2.0}},
                              "static_cov_update_fn_builder": static}}
        got, ref = instantiate(node), j_instantiate(node)
        assert type(got) is cls
        assert got.static_cov_update == StaticDiagonalUpdate(scale=0.25)
        assert got.static_cov_update.scale == ref.static_cov_update.scale
        assert got.cov_update.scale == ref.cov_update.scale == 2.0
