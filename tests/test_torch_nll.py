"""Parity of the PyTorch port's tempered NLL with the JAX package: the
uniform-grid ``make_nll`` (and its general loop on an irregular grid), the plain version of the nll_fwd kernel
(``ops/nll_kernel.py``) against JAX's ``make_nll_tiles`` and ``make_nll``,
the kernel wrapper's CPU route, ``supports``, ``utils/carry.py`` and
``make_nll_landscape``.

Rigs are short Lotka-Volterra problems like ``_lv_rig`` of
tests/test_pallas_ekf.py, with observations made from a numpy seed.
Tolerances: float64 rtol 1e-9; float32 rtol 2e-4 / atol 1e-4 (those of
tests/test_pallas_ekf.py:165).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.filters import SqrtEKF as JEKF
from ode_uncertainty_tpu.inference import make_nll as j_make_nll
from ode_uncertainty_tpu.inference import make_nll_landscape as j_landscape
from ode_uncertainty_tpu.inference import make_obs_model as j_obs
from ode_uncertainty_tpu.inference import make_param_spec as j_spec
from ode_uncertainty_tpu.ops import const_diag as j_const_diag
from ode_uncertainty_tpu.ops.pallas_ekf import make_nll_tiles as j_tiles
from ode_uncertainty_tpu.ops.pallas_ekf import supports as j_supports
from ode_uncertainty_tpu_torch import solvers as ts
from ode_uncertainty_tpu_torch.filters import SqrtEKF as TEKF
from ode_uncertainty_tpu_torch.inference import make_nll as t_make_nll
from ode_uncertainty_tpu_torch.inference import make_nll_landscape as t_landscape
from ode_uncertainty_tpu_torch.ops import nll_kernel
from ode_uncertainty_tpu_torch.utils.carry import rig_from_numpy

TOL = {
    "float64": dict(rtol=1e-9, atol=0.0),
    "float32": dict(rtol=2e-4, atol=1e-4),
}
OPT = {"alpha": True, "beta": True, "gamma": False, "delta": False}
_CACHE: dict = {}


def _jax_rig(dtype, L, num_steps, obs_every, with_t0_row=False):
    """A JAX LV rig; ``with_t0_row`` keeps a t = 0 observation row the grid
    never reads (as the shipped observation files have)."""
    jdt = getattr(jnp, dtype)
    m, h = jm.lotka_volterra(), 0.01
    sol = js.rkf45(h)
    x0 = jnp.array([[1.0, 1.0]], jdt)
    gt = js.solve(sol, m, 0.0, x0, num_steps)
    idx = np.arange(0 if with_t0_row else obs_every, num_steps + 1, obs_every)
    ys = np.asarray(gt["x"])[idx].reshape(len(idx), -1)
    ys = ys + np.sqrt(0.01) * np.random.default_rng(0).standard_normal(ys.shape)
    h_mat = np.eye(2) if L == 2 else np.array([[1.0, 0.0]])
    obs = j_obs(h_mat, np.asarray(gt["t"])[idx], ys, 0.01, 0.0, h, num_steps, dtype=jdt)
    spec = j_spec(m.params, {k: (0.1, 5.0) for k in m.params}, OPT, dtype=jdt)
    ekf = JEKF(disable_cov_update=True)
    state0 = ekf.init_state(0.0, x0, j_const_diag(2, 1e-6, jdt), obs.obs_dim)
    return m, sol, ekf, spec, obs, state0, num_steps


def _to_numpy(jrig):
    """The JAX rig's values as numpy arrays (the input of rig_from_numpy)."""
    m, sol, ekf, spec, obs, state0, num_steps = jrig
    mask = np.zeros(spec.num_full, bool)
    mask[np.asarray(spec.opt_indices)] = True
    return {
        "model": m.name,
        "params": {k: np.array(v) for k, v in m.params.items()},
        "tableau": sol.tableau.name,
        "h": sol.h,
        "num_steps": num_steps,
        "t0": float(state0.t),
        "disable_cov_update": ekf.disable_cov_update,
        "spec_keys": spec.keys,
        "spec_shapes": spec.shapes,
        "defaults": np.asarray(spec.defaults_flat),
        "mins": np.asarray(spec.mins_flat),
        "maxs": np.asarray(spec.maxs_flat),
        "opt_mask": mask,
        "x0": np.asarray(state0.x),
        "P0_sqrt": np.asarray(state0.P_sqrt),
        "H": np.asarray(obs.H),
        "R_sqrt": np.asarray(obs.R_sqrt),
        "q_sqrt": np.eye(2),
        "ys": np.asarray(obs.ys),
        "flags": np.asarray(obs.flags),
        "index_map": np.asarray(obs.index_map),
    }


def _rigs(dtype, L, num_steps=12, obs_every=3, with_t0_row=False):
    key = (dtype, L, num_steps, obs_every, with_t0_row)
    if key not in _CACHE:
        jrig = _jax_rig(dtype, L, num_steps, obs_every, with_t0_row)
        trig = rig_from_numpy(_to_numpy(jrig), device="cpu", dtype=getattr(torch, dtype))
        _CACHE[key] = (jrig, trig)
    return _CACHE[key]


def _points(n=8, seed=1):
    return np.random.default_rng(seed).uniform(size=(n, 2))


def _jax_nll(jrig, dtype, p, gamma):
    """JAX make_nll over a batch (one jit per rig; gamma is traced)."""
    jdt = getattr(jnp, dtype)
    key = ("jax_nll", id(jrig))
    if key not in _CACHE:
        nll = j_make_nll(*jrig)
        q = jnp.eye(2, dtype=jdt)
        _CACHE[key] = jax.jit(jax.vmap(lambda x, g: nll(x, q, g), in_axes=(0, None)))
    return np.asarray(_CACHE[key](jnp.asarray(p, jdt), jnp.asarray(gamma ** 0.5, jdt)))


def _port_args(trig):
    return trig.model, trig.solver, trig.ekf, trig.spec, trig.obs, trig.state0, trig.num_steps


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("gamma", [0.1, 0.0])
def test_make_nll_matches_jax(dtype, L, gamma):
    jrig, trig = _rigs(dtype, L)
    p = _points()
    ref = _jax_nll(jrig, dtype, p, gamma)
    tdt = getattr(torch, dtype)
    nll = t_make_nll(*_port_args(trig))
    got = nll(torch.as_tensor(p, dtype=tdt), trig.q_sqrt, torch.tensor(gamma ** 0.5, dtype=tdt))
    np.testing.assert_allclose(got.numpy(), ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("L", [1, 2])
def test_kernel_plain_version_matches_jax_tiles_and_make_nll(dtype, L):
    # shortest horizon that runs both interval kinds (the JAX tile program
    # unrolls every step at trace time)
    jrig, trig = _rigs(dtype, L, num_steps=4, obs_every=2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p = _points()
    j_nll_t = j_tiles(*jrig, np.eye(2))
    plain = nll_kernel.make_nll_tiles(*_port_args(trig), trig.q_sqrt)
    for gamma in (0.1, 0.0):
        got = plain(torch.as_tensor(p), gamma ** 0.5).numpy()
        ref_tiles = np.asarray(j_nll_t(jnp.asarray(p, jdt), jnp.asarray(gamma ** 0.5, jdt)))
        np.testing.assert_allclose(got, ref_tiles, **TOL[dtype])
        np.testing.assert_allclose(got, _jax_nll(jrig, dtype, p, gamma), **TOL[dtype])
        assert got.dtype == np.dtype(dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_wrapper_runs_the_plain_version_on_cpu(dtype):
    jrig, trig = _rigs(dtype, 2)
    fn = nll_kernel.make_nll_cuda(*_port_args(trig), trig.q_sqrt)
    p = torch.as_tensor(_points(5, seed=2))
    before = dict(nll_kernel.launches)
    got = fn(p, 0.3)
    assert nll_kernel.launches == before  # only a CUDA launch counts
    want = nll_kernel.nll_plain(fn.cm, fn.physical(p), fn.ys, 0.3)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), _jax_nll(jrig, dtype, p.numpy(), 0.09), **TOL[dtype])
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn.launch(fn.physical(p), 0.3)


def test_plain_version_takes_a_gamma_per_lane():
    _, trig = _rigs("float64", 2)
    plain = nll_kernel.make_nll_tiles(*_port_args(trig), trig.q_sqrt)
    p = torch.as_tensor(_points(6, seed=3))
    g = torch.tensor([0.1, 0.0, 0.3, 0.1, 0.0, 0.3], dtype=torch.float64)
    got = plain(p, g)
    for gs in (0.1, 0.0, 0.3):
        idx = (g == gs).nonzero()[:, 0]
        torch.testing.assert_close(got[idx], plain(p[idx], gs), rtol=1e-12, atol=0.0)


def test_t0_row_is_compacted_and_matches_jax_general_path():
    # the JAX kernel rejects a grid whose rows start at 1; the port drops the
    # unread row, takes the kernel path and agrees with JAX's general loop
    jrig, trig = _rigs("float64", 1, num_steps=12, obs_every=1, with_t0_row=True)
    m, sol, ekf, spec, obs, state0, num_steps = jrig
    assert not j_supports(m, sol, ekf, obs)
    assert nll_kernel.supports(trig.model, trig.solver, trig.ekf, trig.obs)
    p = _points()
    fn = nll_kernel.make_nll_cuda(*_port_args(trig), trig.q_sqrt)
    for gamma in (0.1, 0.0):
        got = fn(torch.as_tensor(p), gamma ** 0.5).numpy()
        np.testing.assert_allclose(got, _jax_nll(jrig, "float64", p, gamma), rtol=1e-9)


def test_supports_rules():
    _, trig = _rigs("float64", 2)
    args = dict(model=trig.model, solver=trig.solver, ekf=trig.ekf, obs=trig.obs)
    assert nll_kernel.supports(**args)

    class OtherFilter(TEKF):
        pass

    assert not nll_kernel.supports(**{**args, "ekf": OtherFilter(disable_cov_update=True)})
    assert not nll_kernel.supports(**{**args, "ekf": TEKF(disable_cov_update=False)})
    # every ERK tableau and the implicit step are instantiated on Lotka-Volterra
    assert nll_kernel.supports(**{**args, "solver": ts.dopri65(0.01)}, grad=True)
    assert nll_kernel.supports(**{**args, "solver": ts.kvaerno3(0.01)}, grad=True)
    flags = trig.obs.flags.clone()
    flags[flags.nonzero()[0, 0]] = False  # irregular grid
    irregular = type(trig.obs)(trig.obs.H, trig.obs.R_sqrt, trig.obs.ys, flags, trig.obs.index_map)
    assert not nll_kernel.supports(**{**args, "obs": irregular})
    with pytest.raises(ValueError, match="not covered"):
        nll_kernel.make_nll_cuda(trig.model, trig.solver, TEKF(), trig.spec, trig.obs,
                                 trig.state0, trig.num_steps, trig.q_sqrt)
    # the port's make_nll takes its general loop there, as JAX's does
    jrig, _ = _rigs("float64", 2)
    j_irregular = dataclasses.replace(jrig[4], flags=jnp.asarray(flags.numpy()))
    p = _points()
    # kept in the cache: _jax_nll caches its jit by the rig's id
    j_rig = _CACHE.setdefault("irregular_jrig", (*jrig[:4], j_irregular, *jrig[5:]))
    ref = _jax_nll(j_rig, "float64", p, 0.1)
    got = t_make_nll(trig.model, trig.solver, trig.ekf, trig.spec, irregular, trig.state0, trig.num_steps)(
        torch.as_tensor(p), trig.q_sqrt, torch.tensor(0.1 ** 0.5, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), ref, **TOL["float64"])


@pytest.mark.parametrize("route", ["make_nll", "kernel"])
def test_nll_landscape_matches_jax(route):
    # 4 x 4 grid over 2 tempering stages, in batches that do not divide it
    jrig, trig = _rigs("float64", 2)
    axes = [np.linspace(0.0, 1.0, 4)] * 2
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 2)
    gammas = np.array([1e-2, 0.0])
    ref = j_landscape(j_make_nll(*jrig), jnp.eye(2), batch_size=6)(jnp.asarray(grid), jnp.asarray(gammas))
    if route == "kernel":
        fn = nll_kernel.make_nll_cuda(*_port_args(trig), trig.q_sqrt)
        nll = lambda p, q, g: fn(p, g)
    else:
        nll = t_make_nll(*_port_args(trig))
    timings = []
    got = t_landscape(nll, trig.q_sqrt, batch_size=6, timings_out=timings)(
        torch.as_tensor(grid), torch.as_tensor(gammas)
    )
    assert tuple(got.shape) == (2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9)
    assert [n for n, _ in timings] == [6, 6, 4, 6, 6, 4]
