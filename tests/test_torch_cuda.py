"""The nll_fwd and nll_bwd CUDA kernels (and their Kvaerno3
Hodgkin-Huxley instantiations) against their plain PyTorch versions, on the
card.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py``.
Without a card it skips (the kernels have no CPU mode; ``chip_smoke.py`` runs
them at full size). Tolerances: values, float64 rtol 1e-9 and float32 rtol
2e-4 / atol 1e-4 against the float32 plain version; gradients, float64 rtol
1e-9 (elements where the plain gradient is 0 relative to its largest
magnitude) and float32 |k - p| / (|p| + 1) <= 5e-3 against the float64 plain
version (the gradient rtol of tests/test_pallas_ekf.py). Kvaerno3 values
(HH reduced-4 and full, 200 steps across the stimulus onset, on the
committed observations): float64 rtol 1e-9; float32 lane-normalized
|k - p| / (|p| + 1) <= 5e-4 against the float64 plain version (the implicit
value tolerance of tests/test_pallas_ekf.py:314). Kvaerno3 gradients (HH
reduced-4, the same 200-step onset rig, g_Na varied): float64 rtol 1e-9
against the float64 plain version (on the host's CPU); float32 lane-normalized
|k - p| / (|p| + 1) <= 1e-2 (the implicit gradient tolerance of
tests/test_pallas_ekf.py:319). The Kvaerno3 kernels run a team of threads
per lane, several teams to a warp; batches of 1, 3, 33 and 257 lanes leave
the last warp part empty, with the same limits (a 40-step onset rig; values
and gradients of reduced-4, reduced-1 and full). The
Lotka-Volterra kernels run on the same ragged batches (a 100-step rig with
a correct after every step at L = 1 and every 10th at L = 2) against the
float64 plain version on the host's CPU: values float64 rtol 1e-9, float32
|k - p| / (|p| + 1) <= 2e-4; gradients float64 rtol 1e-9, float32
|k - p| / (|p| + 1) <= 5e-3. So do the explicit-step instantiations of the
other tile models and tableaus (every tableau on Lotka-Volterra, Lorenz, van
der Pol, the pendulum, logistic and exponential growth, every L in 1..n;
40-step rigs with a correct every second step), at gamma^1/2 = 0.1 and 0.
The team instantiations added beside them (Kvaerno3 on every tile model at
every L, on 20-step rigs; every explicit tableau on the single-compartment
Hodgkin-Huxley variants, on 6-step rigs across the stimulus edge from
t = 9.98) run batches of 1 and 33 lanes at gamma^1/2 = 0.1 and 0 against the
float64 plain version on the host's CPU: float64 rtol 1e-9 (values and
gradients); float32 |k - p| / (|p| + 1) <= 5e-4 / 1e-2 (Kvaerno3) and
2e-4 / 5e-3 (explicit tableaus).
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from ode_uncertainty_tpu_torch import models, solvers
from ode_uncertainty_tpu_torch.filters import SqrtEKF
from ode_uncertainty_tpu_torch.inference import make_obs_model, make_param_spec
from ode_uncertainty_tpu_torch.ops import const_diag, nll_kernel
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment, parse_literal

import chip_smoke  # the erk rigs, like the package imported from the repository root

DATA = Path(__file__).resolve().parents[1] / "ode_uncertainty_tpu_torch" / "data"


def _kernel(dtype, obs_rows, num_steps=200, obs_every=5):
    m, sol = models.lotka_volterra(), solvers.rkf45(0.01)
    x0 = torch.tensor([[1.0, 1.0]], dtype=dtype, device="cuda")
    gt = solvers.solve(sol, m, 0.0, x0, num_steps)
    idx = np.arange(obs_every, num_steps + 1, obs_every)
    ys = gt["x"].cpu().numpy()[idx].reshape(len(idx), -1)
    ys = ys + np.sqrt(0.1) * np.random.default_rng(0).standard_normal(ys.shape)
    obs = make_obs_model(np.asarray(obs_rows), gt["t"].cpu().numpy()[idx], ys, 0.1, 0.0, 0.01,
                         num_steps, dtype=dtype, device="cuda")
    spec = make_param_spec(m.params, {k: (0.1, 5.0) for k in m.params},
                           {"alpha": True, "beta": True, "gamma": False, "delta": False},
                           dtype=dtype, device="cuda")
    ekf = SqrtEKF(disable_cov_update=True)
    state0 = ekf.init_state(0.0, x0, const_diag(2, 1e-12, dtype, "cuda"), obs.obs_dim)
    return nll_kernel.make_nll_cuda(m, sol, ekf, spec, obs, state0, num_steps,
                                    torch.eye(2, dtype=dtype, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("obs_rows", [[[1.0, 0.0]], [[1.0, 0.0], [0.0, 1.0]]])
def test_kernel_matches_plain_version_on_the_card(dtype, obs_rows):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the nll_fwd kernel has no CPU mode (chip_smoke.py runs it)")
    tol = dict(rtol=1e-9, atol=0.0) if dtype == "float64" else dict(rtol=2e-4, atol=1e-4)
    fn = _kernel(getattr(torch, dtype), obs_rows)
    p = torch.as_tensor(np.random.default_rng(1).uniform(size=(100, 2)), device="cuda")
    for gamma_sqrt in (0.1, 0.0):
        before = nll_kernel.launches["nll_fwd"]
        got = fn(p, gamma_sqrt)
        torch.cuda.synchronize()
        assert nll_kernel.launches["nll_fwd"] == before + 1
        want = nll_kernel.nll_plain(fn.cm, fn.physical(p), fn.ys, gamma_sqrt)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)


def _grad_err(kernel_vals, plain_vals):
    k = np.asarray(kernel_vals, np.float64)
    p = np.asarray(plain_vals, np.float64)
    rel = np.abs(k - p) / np.where(p != 0, np.abs(p), np.abs(p).max())
    return float(rel.max()), float((np.abs(k - p) / (np.abs(p) + 1.0)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("obs_rows", [[[1.0, 0.0]], [[1.0, 0.0], [0.0, 1.0]]])
def test_grad_kernel_matches_plain_version_on_the_card(dtype, obs_rows):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the nll_bwd kernel has no CPU mode (chip_smoke.py runs it)")
    fn = _kernel(getattr(torch, dtype), obs_rows, num_steps=60)
    fn64 = _kernel(torch.float64, obs_rows, num_steps=60)
    rng = np.random.default_rng(2)
    p = torch.as_tensor(rng.uniform(size=(40, 2)), device="cuda")
    g = torch.as_tensor(rng.uniform(0.5, 1.5, size=40), device="cuda")
    for gamma_sqrt in (0.1, 0.0):
        before = nll_kernel.launches["nll_bwd"]
        dphys, dgam = fn.grad.launch(fn.physical(p), gamma_sqrt, g)
        torch.cuda.synchronize()
        assert nll_kernel.launches["nll_bwd"] == before + 1
        want_dphys, want_dgam = nll_kernel.nll_grad_plain(
            fn64.cm, fn64.physical(p), fn64.ys, torch.full((40,), gamma_sqrt, device="cuda", dtype=torch.float64),
            g.double())
        got = torch.cat([dphys, dgam[None]]).cpu().numpy()
        want = torch.cat([want_dphys, want_dgam[None]]).cpu().numpy()
        assert np.isfinite(got).all()
        rel, lane = _grad_err(got, want)
        if dtype == "float64":
            assert rel <= 1e-9, rel
        else:
            assert lane <= 5e-3, lane


_RAGGED = (1, 3, 33, 257)  # lanes: none of them fills the last warp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("obs_rows,obs_every", [([[1.0, 0.0]], 1), ([[1.0, 0.0], [0.0, 1.0]], 10)])
def test_lv_kernels_on_ragged_batches(dtype, obs_rows, obs_every):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the NLL kernels have no CPU mode (chip_smoke.py runs them)")
    fn = _kernel(getattr(torch, dtype), obs_rows, num_steps=100, obs_every=obs_every)
    fn64 = _kernel(torch.float64, obs_rows, num_steps=100, obs_every=obs_every)
    p = torch.as_tensor(np.random.default_rng(8).uniform(size=(max(_RAGGED), 2)), device="cuda")
    phys64, ys64 = fn64.physical(p).cpu(), fn64.ys.cpu()
    want = nll_kernel.nll_plain(fn64.cm, phys64, ys64, 0.1).numpy()
    ones = torch.ones(max(_RAGGED), dtype=torch.float64)
    dphys, dgamma = nll_kernel.nll_grad_plain(fn64.cm, phys64, ys64, torch.full_like(ones, 0.1), ones)
    want_grad = torch.cat([dphys, dgamma[None]]).numpy()
    for batch in _RAGGED:
        got = fn(p[:batch], 0.1)
        g = torch.ones(batch, dtype=fn.cm.dtype, device="cuda")
        dp, dg = fn.grad.launch(fn.physical(p[:batch]), 0.1, g)
        torch.cuda.synchronize()
        got = got.double().cpu().numpy()
        got_grad = torch.cat([dp, dg[None]]).double().cpu().numpy()
        assert got.shape == (batch,) and np.isfinite(got).all() and np.isfinite(got_grad).all()
        rel, lane = _grad_err(got_grad, want_grad[:, :batch])
        if dtype == "float64":
            np.testing.assert_allclose(got, want[:batch], rtol=1e-9, atol=0.0)
            assert rel <= 1e-9, (batch, rel)
        else:
            assert (np.abs(got - want[:batch]) / (np.abs(want[:batch]) + 1.0)).max() <= 2e-4
            assert lane <= 5e-3, (batch, lane)


@pytest.mark.cuda
def test_autograd_function_launches_both_kernels_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the NLL kernels have no CPU mode (chip_smoke.py runs them)")
    fn = _kernel(torch.float64, [[1.0, 0.0]], num_steps=60)
    p = torch.as_tensor(np.random.default_rng(3).uniform(size=(16, 2)), device="cuda").requires_grad_(True)
    gs = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    before = dict(nll_kernel.launches)
    fn(p, gs).sum().backward()
    torch.cuda.synchronize()
    assert nll_kernel.launches["nll_fwd"] == before["nll_fwd"] + 1
    assert nll_kernel.launches["nll_bwd"] == before["nll_bwd"] + 1
    q = p.detach().clone().requires_grad_(True)
    gq = gs.detach().clone().requires_grad_(True)
    nll_kernel.nll_plain(fn.cm, fn.physical(q), fn.ys, gq).sum().backward()
    np.testing.assert_allclose(p.grad.cpu().numpy(), q.grad.cpu().numpy(), rtol=1e-9)
    assert gs.grad.device.type == "cpu"
    np.testing.assert_allclose(float(gs.grad), float(gq.grad), rtol=1e-9)


def _hh_kernel(experiment, data, dtype, t0=9.9, steps=200):
    """An HH experiment's Kvaerno3 rig of ``steps`` steps from the rest state
    at t0, on the committed observation rows at those times, varying g_Na
    (the main path's parameter; over hodgkinhuxley7_full's seven-parameter
    box float32 itself is ~4e-3 off float64, see PERF.md)."""
    cfg = build_config(load_experiment(experiment), {"device": "cuda"})
    model, solver, ekf = cfg["ode_builder"], cfg["solver_builder"], cfg["filter_builder"]
    n = model.state_size
    x0 = model.build_initial_value(torch.tensor([[-70.0]], dtype=torch.float64), model.params)
    obs_file = np.load(DATA / data)
    rows = slice(int(round(t0 / solver.h)) + 1, int(round(t0 / solver.h)) + steps + 1)
    # the committed trace of the full model serves the reduced-1 one (n = 7) too
    obs = make_obs_model(np.asarray(parse_literal(cfg["measurement_matrix"]), float), obs_file["t"][rows],
                         obs_file["x"][rows].reshape(steps, -1)[:, :n], cfg["obs_noise_var"], t0, solver.h, steps,
                         dtype=dtype, device="cuda")
    spec = make_param_spec(model.params, cfg["params_range"], {k: k == "g_Na" for k in model.params},
                           dtype=dtype, device="cuda")
    state0 = ekf.init_state(t0, x0.to(dtype).cuda(), const_diag(n, 1e-12, dtype, "cuda"), obs.obs_dim)
    return nll_kernel.make_nll_cuda(model, solver, ekf, spec, obs, state0, steps,
                                    torch.eye(n, dtype=dtype, device="cuda"))


_PLAIN: dict = {}


def _hh_plain(experiment, data, p, gammas):
    """The float64 plain version on the host's CPU (faster there than on the
    card, where each of its small operations is a launch), once per rig."""
    if experiment not in _PLAIN:
        fn64 = _hh_kernel(experiment, data, torch.float64)
        phys = fn64.physical(p).cpu()
        _PLAIN[experiment] = nll_kernel.nll_plain(fn64.cm, phys, fn64.ys.cpu(), gammas.cpu()).numpy()
    return _PLAIN[experiment]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("experiment,data", [("params/hodgkinhuxley1_r4", "hodgkinhuxley_r4.npz"),
                                             ("params/hodgkinhuxley7_full", "hodgkinhuxley_full.npz")])
def test_kvaerno3_kernel_matches_plain_version_on_the_card(dtype, experiment, data):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the nll_fwd kernel has no CPU mode (chip_smoke.py runs it)")
    fn = _hh_kernel(experiment, data, getattr(torch, dtype))
    p = torch.as_tensor(np.random.default_rng(4).uniform(size=(16, fn.spec.num_opt)), device="cuda")
    gammas = torch.tensor([0.1] * 16 + [0.0] * 16, dtype=torch.float64)
    want = _hh_plain(experiment, data, torch.cat([p, p]), gammas)
    before = nll_kernel.launches["nll_fwd"]
    got = torch.cat([fn(p, 0.1), fn(p, 0.0)])
    torch.cuda.synchronize()
    assert nll_kernel.launches["nll_fwd"] == before + 2
    got = got.double().cpu().numpy()
    assert np.isfinite(got).all()
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0.0)
    else:
        assert (np.abs(got - want) / (np.abs(want) + 1.0)).max() <= 5e-4


_PLAIN_GRAD: dict = {}


def _hh_plain_grad(p, gammas, g):
    """The float64 plain gradient [K + 1, B] of the reduced-4 onset rig on the
    host's CPU (each lane's d/d gamma^1/2 in the last row), once."""
    if "r4" not in _PLAIN_GRAD:
        fn64 = _hh_kernel("params/hodgkinhuxley1_r4", "hodgkinhuxley_r4.npz", torch.float64)
        dphys, dgamma = nll_kernel.nll_grad_plain(fn64.cm, fn64.physical(p).cpu(), fn64.ys.cpu(), gammas.cpu(),
                                                  g.cpu().double())
        _PLAIN_GRAD["r4"] = torch.cat([dphys, dgamma[None]]).numpy()
    return _PLAIN_GRAD["r4"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kvaerno3_grad_kernel_matches_plain_version_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the nll_bwd kernel has no CPU mode (chip_smoke.py runs it)")
    fn = _hh_kernel("params/hodgkinhuxley1_r4", "hodgkinhuxley_r4.npz", getattr(torch, dtype))
    rng = np.random.default_rng(5)
    p = torch.as_tensor(rng.uniform(size=(16, 1)), device="cuda")
    g = torch.as_tensor(rng.uniform(0.5, 1.5, size=32), device="cuda")
    gammas = torch.tensor([0.1] * 16 + [0.0] * 16, dtype=torch.float64)
    want = _hh_plain_grad(torch.cat([p, p]), gammas, g)
    before = nll_kernel.launches["nll_bwd"]
    parts = [fn.grad.launch(fn.physical(p), gs, g[sl]) for gs, sl in ((0.1, slice(0, 16)), (0.0, slice(16, None)))]
    torch.cuda.synchronize()
    assert nll_kernel.launches["nll_bwd"] == before + 2
    got = torch.cat([torch.cat([dp, dg[None]]) for dp, dg in parts], dim=1).double().cpu().numpy()
    assert np.isfinite(got).all()
    rel, lane = _grad_err(got, want)
    if dtype == "float64":
        assert rel <= 1e-9, rel
    else:
        assert lane <= 1e-2, lane
    # a launch over the optimized row alone gives the same row, zeros elsewhere
    rows = fn.opt_rows
    part, none = fn.grad.launch(fn.physical(p), 0.1, g[:16], with_dgamma=False, rows=rows)
    torch.cuda.synchronize()
    assert none is None and torch.equal(part[list(rows)], parts[0][0][list(rows)])
    others = [r for r in range(fn.cm.k_params) if r not in rows]
    assert not part[others].any()


_RAGGED_STEPS = 40
_RAGGED_PLAIN: dict = {}


def _ragged_plain(experiment, data, p, grad):
    """The float64 plain version (or gradient, every row and each lane's
    d/d gamma^1/2, cotangent 1) of a 40-step onset rig at gamma^1/2 = 0.1
    on the host's CPU, once per rig."""
    key = (experiment, grad)
    if key not in _RAGGED_PLAIN:
        fn64 = _hh_kernel(experiment, data, torch.float64, steps=_RAGGED_STEPS)
        phys, ys = fn64.physical(p).cpu(), fn64.ys.cpu()
        if grad:
            ones = torch.ones(p.shape[0], dtype=torch.float64)
            dphys, dgamma = nll_kernel.nll_grad_plain(fn64.cm, phys, ys, torch.full_like(ones, 0.1), ones)
            _RAGGED_PLAIN[key] = torch.cat([dphys, dgamma[None]]).numpy()
        else:
            _RAGGED_PLAIN[key] = nll_kernel.nll_plain(fn64.cm, phys, ys, 0.1).numpy()
    return _RAGGED_PLAIN[key]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("experiment,data", [("params/hodgkinhuxley1_r4", "hodgkinhuxley_r4.npz"),
                                             ("params/hodgkinhuxley6_r1", "hodgkinhuxley_full.npz"),
                                             ("params/hodgkinhuxley7_full", "hodgkinhuxley_full.npz")])
def test_kvaerno3_team_kernel_on_ragged_batches(dtype, experiment, data):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the nll_fwd kernel has no CPU mode (chip_smoke.py runs it)")
    fn = _hh_kernel(experiment, data, getattr(torch, dtype), steps=_RAGGED_STEPS)
    p = torch.as_tensor(np.random.default_rng(6).uniform(size=(max(_RAGGED), fn.spec.num_opt)), device="cuda")
    want = _ragged_plain(experiment, data, p, grad=False)
    for batch in _RAGGED:
        got = fn(p[:batch], 0.1)
        torch.cuda.synchronize()
        got = got.double().cpu().numpy()
        assert got.shape == (batch,) and np.isfinite(got).all()
        if dtype == "float64":
            np.testing.assert_allclose(got, want[:batch], rtol=1e-9, atol=0.0)
        else:
            assert (np.abs(got - want[:batch]) / (np.abs(want[:batch]) + 1.0)).max() <= 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("experiment,data", [("params/hodgkinhuxley1_r4", "hodgkinhuxley_r4.npz"),
                                             ("params/hodgkinhuxley6_r1", "hodgkinhuxley_full.npz"),
                                             ("params/hodgkinhuxley7_full", "hodgkinhuxley_full.npz")])
def test_kvaerno3_team_grad_kernel_on_ragged_batches(dtype, experiment, data):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the nll_bwd kernel has no CPU mode (chip_smoke.py runs it)")
    fn = _hh_kernel(experiment, data, getattr(torch, dtype), steps=_RAGGED_STEPS)
    p = torch.as_tensor(np.random.default_rng(7).uniform(size=(max(_RAGGED), 1)), device="cuda")
    want = _ragged_plain(experiment, data, p, grad=True)
    for batch in _RAGGED:
        ones = torch.ones(batch, dtype=fn.cm.dtype, device="cuda")
        dphys, dgamma = fn.grad.launch(fn.physical(p[:batch]), 0.1, ones)
        torch.cuda.synchronize()
        got = torch.cat([dphys, dgamma[None]]).double().cpu().numpy()
        assert got.shape == (fn.cm.k_params + 1, batch) and np.isfinite(got).all()
        rel, lane = _grad_err(got, want[:, :batch])
        if dtype == "float64":
            assert rel <= 1e-9, (batch, rel)
        else:
            assert lane <= 1e-2, (batch, lane)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("model,tableau,L", chip_smoke.erk_chains())
def test_erk_instantiations_match_plain_versions_on_ragged_batches(dtype, model, tableau, L):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the NLL kernels have no CPU mode (chip_smoke.py runs them)")
    # chip_smoke's erk_parity rigs at 40 steps, a correct every second step
    fn = chip_smoke.erk_kernel(model, tableau, L, getattr(torch, dtype), 40, 2, "cuda")
    fn64 = chip_smoke.erk_kernel(model, tableau, L, torch.float64, 40, 2, "cpu")
    k = fn64.spec.num_opt
    p = np.random.default_rng(9).uniform(size=(max(_RAGGED), k))
    phys64 = fn64.physical(torch.as_tensor(p))
    ones = torch.ones(max(_RAGGED), dtype=torch.float64)
    for gamma_sqrt in (0.1, 0.0):
        want = nll_kernel.nll_plain(fn64.cm, phys64, fn64.ys, gamma_sqrt).numpy()
        dphys, dgamma = nll_kernel.nll_grad_plain(fn64.cm, phys64, fn64.ys, torch.full_like(ones, gamma_sqrt), ones)
        want_grad = torch.cat([dphys, dgamma[None]]).numpy()
        for batch in _RAGGED:
            phys = fn.physical(torch.as_tensor(p[:batch], device="cuda"))
            got = fn.launch(phys, gamma_sqrt)
            dp, dg = fn.grad.launch(phys, gamma_sqrt, torch.ones(batch, dtype=fn.cm.dtype, device="cuda"))
            torch.cuda.synchronize()
            got = got.double().cpu().numpy()
            got_grad = torch.cat([dp, dg[None]]).double().cpu().numpy()
            assert got.shape == (batch,) and np.isfinite(got).all() and np.isfinite(got_grad).all()
            rel, lane = _grad_err(got_grad, want_grad[:, :batch])
            if dtype == "float64":
                np.testing.assert_allclose(got, want[:batch], rtol=1e-9, atol=0.0)
                assert rel <= 1e-9, (batch, rel)
            else:
                assert (np.abs(got - want[:batch]) / (np.abs(want[:batch]) + 1.0)).max() <= 2e-4
                assert lane <= 5e-3, (batch, lane)


_TEAM_BATCHES = (1, 33)


def _team_steps(model):
    return 6 if model in chip_smoke.TEAM_HH else 20


@functools.cache
def _team_plain(model, tableau, L):
    """The float64 plain values and gradients of a team chain's rig on the
    host's CPU: the points, and per gamma^1/2 (0.1, 0) the values [33] and
    the gradients [K + 1, 33]."""
    fn64 = chip_smoke.team_kernel(model, tableau, L, torch.float64, _team_steps(model), "cpu")
    p = np.random.default_rng(11).uniform(size=(max(_TEAM_BATCHES), fn64.spec.num_opt))
    phys64 = fn64.physical(torch.as_tensor(p))
    ones = torch.ones(len(p), dtype=torch.float64)
    want = {}
    for gamma_sqrt in (0.1, 0.0):
        vals = nll_kernel.nll_plain(fn64.cm, phys64, fn64.ys, gamma_sqrt).numpy()
        dphys, dgamma = nll_kernel.nll_grad_plain(fn64.cm, phys64, fn64.ys, torch.full_like(ones, gamma_sqrt), ones)
        want[gamma_sqrt] = (vals, torch.cat([dphys, dgamma[None]]).numpy())
    return p, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("model,tableau,L", chip_smoke.team_chains())
def test_team_instantiations_match_plain_versions(dtype, model, tableau, L):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the NLL kernels have no CPU mode (chip_smoke.py runs them)")
    fn = chip_smoke.team_kernel(model, tableau, L, getattr(torch, dtype), _team_steps(model), "cuda")
    p, want = _team_plain(model, tableau, L)
    val_limit, grad_limit = (5e-4, 1e-2) if tableau == "kvaerno3" else (2e-4, 5e-3)
    for gamma_sqrt, (vals, grads) in want.items():
        for batch in _TEAM_BATCHES:
            phys = fn.physical(torch.as_tensor(p[:batch], device="cuda"))
            got = fn.launch(phys, gamma_sqrt)
            dp, dg = fn.grad.launch(phys, gamma_sqrt, torch.ones(batch, dtype=fn.cm.dtype, device="cuda"))
            torch.cuda.synchronize()
            got = got.double().cpu().numpy()
            got_grad = torch.cat([dp, dg[None]]).double().cpu().numpy()
            assert got.shape == (batch,) and np.isfinite(got).all() and np.isfinite(got_grad).all()
            rel, lane = _grad_err(got_grad, grads[:, :batch])
            if dtype == "float64":
                np.testing.assert_allclose(got, vals[:batch], rtol=1e-9, atol=0.0)
                assert rel <= 1e-9, (batch, rel)
            else:
                assert (np.abs(got - vals[:batch]) / (np.abs(vals[:batch]) + 1.0)).max() <= val_limit
                assert lane <= grad_limit, (batch, lane)
