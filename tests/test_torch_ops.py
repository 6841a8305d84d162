"""Parity of the PyTorch port's ops, parameter box, observations, schedules
and IO with the JAX package.

Inputs come from a numpy seed and go through both packages. Tolerances:
float64 rtol 1e-9 (atol 1e-12 where values cross zero); float32 rtol 2e-4 /
atol 1e-4 (those of tests/test_pallas_ekf.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import ops as jops
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.inference import make_obs_model as j_make_obs_model
from ode_uncertainty_tpu.inference import make_param_spec as j_make_param_spec
from ode_uncertainty_tpu.inference import schedules as jsched
from ode_uncertainty_tpu.ops import small_qr as j_small_qr
from ode_uncertainty_tpu.ops import tri_solve as j_tri
from ode_uncertainty_tpu.utils import io as j_io
from ode_uncertainty_tpu_torch import models as tm
from ode_uncertainty_tpu_torch import ops as tops
from ode_uncertainty_tpu_torch import solvers as ts
from ode_uncertainty_tpu_torch.inference import make_obs_model as t_make_obs_model
from ode_uncertainty_tpu_torch.inference import make_param_spec as t_make_param_spec
from ode_uncertainty_tpu_torch.inference import schedules as tsched
from ode_uncertainty_tpu_torch.ops import small_qr as t_small_qr
from ode_uncertainty_tpu_torch.ops import tri_solve as t_tri
from ode_uncertainty_tpu_torch.utils import io as t_io

F64 = dict(rtol=1e-9, atol=1e-12)
F32 = dict(rtol=2e-4, atol=1e-4)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _chol(n, seed):
    a = _rand((n, n), seed)
    return np.linalg.cholesky(a @ a.T + n * np.eye(n))


@pytest.mark.parametrize("shape", [(4, 2), (3, 1), (6, 3), (8, 8)])
def test_qr_r_small_matches_jax(shape):
    a = _rand((5,) + shape)
    ref = j_small_qr.qr_r_small(jnp.asarray(a))
    got = t_small_qr.qr_r_small(torch.as_tensor(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F64)


def test_qr_r_small_float32_zero_column_guard():
    # [P; 0]: the zero block of the gamma = 0 stage; the guard keeps the
    # reflector the identity and everything finite, as in the JAX package
    a = np.zeros((3, 4, 2), np.float32)
    a[:, :2, :] = 1e-10 * _rand((3, 2, 2), 1)
    a[1] = 0.0
    ref = j_small_qr.qr_r_small(jnp.asarray(a, jnp.float32))
    got = t_small_qr.qr_r_small(torch.as_tensor(a))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-14)


def test_sqrt_sum_matches_jax():
    # three factors, one of them shared by the whole batch
    a, b, c = _rand((6, 3, 3), 2), _chol(3, 3), _rand((6, 3, 2), 4)
    ref = jops.sqrt_sum(jnp.asarray(a), jnp.broadcast_to(jnp.asarray(b), (6, 3, 3)), jnp.asarray(c))
    got = tops.sqrt_sum(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F64)


@pytest.mark.parametrize("n", [1, 3])
def test_nll_gaussian_sqrt_matches_jax(n):
    x, m = _rand((5, n), 6), _rand((5, n), 7)
    chol = np.stack([_chol(n, 8 + i) for i in range(5)])
    ref = jops.nll_gaussian_sqrt(jnp.asarray(x), jnp.asarray(m), jnp.asarray(chol))
    got = tops.nll_gaussian_sqrt(torch.as_tensor(x), torch.as_tensor(m), torch.as_tensor(chol))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F64)


@pytest.mark.parametrize("n", [1, 3])
def test_cho_solve_sqrt_matches_jax(n):
    chol = np.stack([_chol(n, 20 + i) for i in range(4)])
    b = _rand((4, n, 2), 9)
    ref = jops.cho_solve_sqrt(jnp.asarray(chol), jnp.asarray(b))
    got = tops.cho_solve_sqrt(torch.as_tensor(chol), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F64)


def test_triangular_solves_match_jax():
    chol = np.stack([_chol(4, 30 + i) for i in range(3)])
    b_vec, b_mat = _rand((3, 4), 10), _rand((3, 4, 2), 11)
    upper = np.swapaxes(chol, -1, -2)
    for b in (b_vec, b_mat):
        pairs = [
            (t_tri.solve_lower_unrolled(torch.as_tensor(chol), torch.as_tensor(b)),
             j_tri.solve_lower_unrolled(jnp.asarray(chol), jnp.asarray(b))),
            (t_tri.solve_upper_unrolled(torch.as_tensor(upper), torch.as_tensor(b)),
             j_tri.solve_upper_unrolled(jnp.asarray(upper), jnp.asarray(b))),
            (t_tri.cho_solve_small(torch.as_tensor(chol), torch.as_tensor(b)),
             j_tri.cho_solve_small(jnp.asarray(chol), jnp.asarray(b))),
            (t_tri.solve_triangular_small(torch.as_tensor(upper), torch.as_tensor(b), lower=False),
             j_tri.solve_triangular_small(jnp.asarray(upper), jnp.asarray(b), lower=False)),
        ]
        for got, ref in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F64)


def test_push_sqrt_matches_jax():
    # J @ P of one RKF45 step of Lotka-Volterra, batched over 4 states
    jmod, tmod = jm.lotka_volterra(), tm.lotka_volterra()
    jsol, tsol = js.rkf45(0.05), ts.rkf45(0.05)
    x = np.random.default_rng(12).uniform(0.5, 1.5, (4, 2))
    p = np.stack([_chol(2, 40 + i) for i in range(4)])

    def jstep(xf):
        xn, eps = jsol.step(jmod.rhs, jmod.params, 0.0, xf.reshape(1, 2))
        return xn.reshape(2), eps.reshape(2)

    def tstep(xf):
        xn, eps = tsol.step(tmod.rhs, tmod.params, 0.0, xf.reshape(-1, 1, 2))
        return xn.reshape(-1, 2), eps.reshape(-1, 2)

    (ref_x, ref_eps), ref_jp = jax.vmap(lambda xi, pi: jops.push_sqrt(jstep, xi, pi))(jnp.asarray(x), jnp.asarray(p))
    (got_x, got_eps), got_jp = tops.push_sqrt(tstep, torch.as_tensor(x), torch.as_tensor(p))
    for got, ref in ((got_x, ref_x), (got_eps, ref_eps), (got_jp, ref_jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F64)


def test_const_diag_and_normalize_match_jax():
    np.testing.assert_array_equal(
        tops.const_diag(3, 0.5, torch.float64).numpy(), np.asarray(jops.const_diag(3, 0.5, jnp.float64))
    )
    vals, lo, hi = {"a": 2.0, "b": 0.5}, {"a": 1.0, "b": 0.0}, {"a": 5.0, "b": 2.0}
    t = lambda d: {k: torch.as_tensor(v, dtype=torch.float64) for k, v in d.items()}
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    for tf, jf in ((tops.normalize, jops.normalize), (tops.inv_normalize, jops.inv_normalize)):
        got, ref = tf(t(vals), t(lo), t(hi)), jf(j(vals), j(lo), j(hi))
        for k in vals:
            np.testing.assert_allclose(float(got[k]), float(ref[k]), **F64)
    got, ref = tops.clip01(t({"a": 1.5, "b": -0.2})), jops.clip01(j({"a": 1.5, "b": -0.2}))
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in ref.items()}


def test_observation_maps_match_jax():
    ts_y = np.arange(0, 2.0001, 0.05)
    for tol in (1e-8, 0.0025):
        got = tops.build_observation_maps(0.0, 0.01, 200, ts_y, tol)
        ref = jops.build_observation_maps(0.0, 0.01, 200, ts_y, tol)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def _lv_spec_args():
    m = jm.lotka_volterra()
    return m.params, {k: (0.001, 5.0) for k in m.params}, {"alpha": True, "beta": True, "gamma": False, "delta": False}


def test_param_spec_matches_jax():
    params, ranges, opt = _lv_spec_args()
    jspec = j_make_param_spec(params, ranges, opt, dtype=jnp.float64)
    tspec = t_make_param_spec(tm.lotka_volterra().params, ranges, opt, dtype=torch.float64, device="cpu")
    assert (tspec.keys, tspec.shapes, tspec.opt_keys) == (jspec.keys, jspec.shapes, jspec.opt_keys)
    for f in ("defaults_flat", "mins_flat", "maxs_flat", "opt_indices"):
        np.testing.assert_array_equal(getattr(tspec, f).numpy(), np.asarray(getattr(jspec, f)))

    p = np.random.default_rng(13).uniform(size=(6, 2))
    ref_flat = jax.vmap(lambda q: jspec.flatten(jspec.to_params(q)))(jnp.asarray(p))
    got_flat = tspec.flatten(tspec.to_params(torch.as_tensor(p)))
    np.testing.assert_allclose(got_flat.numpy(), np.asarray(ref_flat), **F64)
    phys = tspec.opt_to_physical(torch.as_tensor(p))
    np.testing.assert_allclose(phys.numpy(), np.asarray(jspec.opt_to_physical(jnp.asarray(p))), **F64)
    unflat = tspec.unflatten(got_flat)
    assert sorted(unflat) == list(tspec.keys) and unflat["alpha"].shape == (6,)


def test_param_spec_sample_norm_uses_the_generator():
    params, ranges, opt = _lv_spec_args()
    spec = t_make_param_spec(tm.lotka_volterra().params, ranges, opt, dtype=torch.float32, device="cpu")
    a = spec.sample_norm(torch.Generator().manual_seed(3), 100)
    b = spec.sample_norm(torch.Generator().manual_seed(3), 100)
    assert a.shape == (100, 2) and a.dtype == torch.float32
    assert torch.equal(a, b) and float(a.min()) >= 0.0 and float(a.max()) < 1.0
    with pytest.raises(ValueError, match="params_range missing"):
        t_make_param_spec(tm.lotka_volterra().params, {}, opt, device="cpu")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_obs_model_matches_jax(dtype):
    # an observation grid with a t = 0 row (as the shipped observation files
    # have): the port drops it, every step reads the same value
    t_dtype, j_dtype = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F64 if dtype == "float64" else F32
    ts_y = np.arange(0, 1.0001, 0.01)
    ys = np.random.default_rng(14).standard_normal((len(ts_y), 1, 2))
    h_mat = np.array([[1.0, 0.0]])
    ref = j_make_obs_model(h_mat, ts_y, ys, 0.1, 0.0, 0.01, 60, dtype=j_dtype)
    got = t_make_obs_model(h_mat, ts_y, ys, 0.1, 0.0, 0.01, 60, dtype=t_dtype, device="cpu")
    np.testing.assert_array_equal(got.flags.numpy(), np.asarray(ref.flags))
    np.testing.assert_allclose(got.H.numpy(), np.asarray(ref.H), **tol)
    np.testing.assert_allclose(got.R_sqrt.numpy(), np.asarray(ref.R_sqrt), **tol)
    steps = np.nonzero(np.asarray(ref.flags))[0]
    got_rows = got.ys.numpy()[got.index_map.numpy()[steps]]
    ref_rows = np.asarray(ref.ys)[np.asarray(ref.index_map)[steps]]
    np.testing.assert_allclose(got_rows, ref_rows, **tol)
    assert got.ys.shape[0] == len(steps)
    np.testing.assert_array_equal(got.index_map.numpy()[steps], np.arange(len(steps)))


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("LinearDecaySchedule", {"init_noise_log": -2.0, "decay_rate": 3.0}),
        ("ExponentialDecaySchedule", {"init_noise_log": 1.0, "decay_rate": 2.0}),
        ("CosineAnnealingSchedule", {"init_noise_log": 0.0, "min_noise_log": -8.0, "cycle_length": 4}),
    ],
)
def test_schedules_match_jax(name, kwargs):
    ref = jsched.SCHEDULE_REGISTRY[name](**kwargs).gammas(6, True)
    got = tsched.SCHEDULE_REGISTRY[name](**kwargs).gammas(6, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("suffix", [".h5", ".npz"])
def test_store_and_load_data(tmp_path, suffix):
    path = tmp_path / f"out{suffix}"
    data = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": np.array([1.5]), "key": np.zeros(1)}
    t_io.store_data(data, str(path))
    t_io.store_data({"c": torch.ones(2)}, str(path), mode="a")
    got = t_io.load_data(str(path))
    assert sorted(got) == ["a", "b", "c"]
    np.testing.assert_array_equal(got["a"], data["a"].numpy())
    # the JAX package reads what the port writes
    ref = j_io.load_data(str(path))
    assert sorted(ref) == sorted(got)
