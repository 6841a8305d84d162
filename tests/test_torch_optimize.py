"""The PyTorch port's tempered ``optimize`` against the JAX package: the host
L-BFGS, the checkpointed stage grid, the stage optimizer's two routes, the
``optimize`` CLI, and the import hygiene of its modules.

Tolerances:
* ``lbfgs_box_host`` on the same numpy objective: identical iterates and
  counters (the loop is host numpy in both packages);
* ``run_stage_grid`` with the same toy stage function: identical outputs;
* the CLI on params/lotkavolterra2 (``tN=0.5``, ``num_random_runs=0`` so
  both sides start from the defaults, 2 tempering stages, ``lbfgs_maxiter=10``,
  float64): ``params_inits``, ``params_default``, ``params_name`` and
  ``gammas`` exactly, the iteration and evaluation counters exactly,
  ``params_optims`` to atol 1e-6 and ``nll_optims`` to rtol 1e-8 (the port
  runs the kernels' tile math on its CPU route, JAX its XLA ``make_nll``:
  the same function to rounding).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu.inference.lbfgs_host import lbfgs_box_host as j_lbfgs
from ode_uncertainty_tpu.utils.checkpoint import run_stage_grid as j_grid
from ode_uncertainty_tpu_torch.inference import lbfgs_box_host as t_lbfgs
from ode_uncertainty_tpu_torch.inference import make_stage_optimizer_host
from ode_uncertainty_tpu_torch.ops import nll_kernel
from ode_uncertainty_tpu_torch.run_parameter_estimation import initial_restarts, optimize
from ode_uncertainty_tpu_torch.utils.checkpoint import run_stage_grid as t_grid
from ode_uncertainty_tpu_torch.utils.checkpoint import unit_sidecar

REPO = Path(__file__).resolve().parent.parent


def _rosenbrock(x):
    """Batched Rosenbrock on [0, 1]^P mapped to [-2, 2]^P: (f [B], g [B, P])."""
    z = 4.0 * np.asarray(x, np.float64) - 2.0
    a, b = z[:, :-1], z[:, 1:]
    f = np.sum(100.0 * (b - a * a) ** 2 + (1.0 - a) ** 2, axis=1)
    gz = np.zeros_like(z)
    gz[:, :-1] += -400.0 * a * (b - a * a) - 2.0 * (1.0 - a)
    gz[:, 1:] += 200.0 * (b - a * a)
    return f, 4.0 * gz


def _counted(fn):
    widths = []

    def vg(x):
        widths.append(len(x))
        return fn(x)

    return vg, widths


@pytest.mark.parametrize(
    "kw",
    [
        dict(ls_trials=1),
        dict(ls_trials=1, f32=False, compact=False),
        dict(ls_trials=8, ls_width_cap=16),
        dict(ls_trials=4, history=3, stall_iters=0),
    ],
    ids=["sequential", "sequential-f64-nocompact", "ladder", "ladder-short-history"],
)
def test_lbfgs_box_host_matches_jax(kw):
    x0 = np.random.default_rng(0).uniform(size=(24, 3))
    vg_j, widths_j = _counted(_rosenbrock)
    vg_t, widths_t = _counted(_rosenbrock)
    ref = j_lbfgs(vg_j, x0, max_iter=40, **kw)
    got = t_lbfgs(vg_t, x0, max_iter=40, **kw)
    for field in ref._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field), err_msg=field)
    assert widths_t == widths_j  # same dispatches, same bucket widths
    assert got.iters.max() > 5 and np.isfinite(got.f).all()


def test_lbfgs_box_host_resumes_from_its_sidecar(tmp_path):
    x0 = np.random.default_rng(1).uniform(size=(8, 2))
    path = str(tmp_path / "unit.lbfgs-r0.npz")
    ref = t_lbfgs(_rosenbrock, x0, max_iter=300)
    assert ref.iters.max() < 300  # every lane stops by itself, so the sidecar goes
    part = t_lbfgs(_rosenbrock, x0, max_iter=4, state_path=path, state_token="gamma=0.1")
    assert os.path.exists(path)  # a max_iter-bounded exit keeps it
    assert part.iters.max() == 4
    vg, widths = _counted(_rosenbrock)
    rest = t_lbfgs(vg, x0, max_iter=300, state_path=path, state_token="gamma=0.1")
    for field in ref._fields:
        np.testing.assert_array_equal(getattr(rest, field), getattr(ref, field), err_msg=field)
    assert not os.path.exists(path)
    # another token (another stage) must not restore it
    t_lbfgs(_rosenbrock, x0, max_iter=4, state_path=path, state_token="gamma=0.1")
    vg, widths = _counted(_rosenbrock)
    t_lbfgs(vg, x0, max_iter=1, state_path=path, state_token="gamma=0.2")
    assert widths[0] == 8  # started from x0: the initial evaluation ran


class _Res:
    def __init__(self, x, f, iters, n_fev):
        self.x, self.f, self.iters, self.n_fev = x, f, iters, n_fev


def _toy_stage(p, gamma, unit_key=None):
    """A deterministic stand-in for one tempering stage."""
    x = np.asarray(p, np.float64)
    x_new = np.clip(0.5 * x + 0.25 + float(gamma), 0.0, 1.0)
    f = np.sum((x_new - 0.3) ** 2, axis=1) + float(gamma)
    return _Res(x_new, f, np.full(len(x), 3 + len(unit_key or "")), np.arange(len(x)) + 1)


def test_run_stage_grid_matches_jax(tmp_path):
    p0 = np.random.default_rng(2).uniform(size=(7, 2))
    gammas = np.array([0.1, 0.01, 0.0])
    to_phys = lambda x: 2.0 * x + 1.0
    ref = j_grid(str(tmp_path / "jax.h5"), p0, gammas, _toy_stage, to_phys, chunk=3, log=lambda s: None)
    got = t_grid(str(tmp_path / "port.h5"), p0, gammas, _toy_stage, to_phys, chunk=3, log=lambda s: None)
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
    assert not unit_sidecar(str(tmp_path / "port.h5")).exists()


def test_run_stage_grid_resumes_from_its_sidecar(tmp_path):
    p0 = np.random.default_rng(3).uniform(size=(5, 2))
    gammas = np.array([0.1, 0.0])
    out = str(tmp_path / "run.h5")
    full = t_grid(str(tmp_path / "full.h5"), p0, gammas, _toy_stage, lambda x: x, chunk=2, log=lambda s: None)

    calls = []

    def failing(p, gamma, unit_key=None):
        if len(calls) == 3:
            raise RuntimeError("killed")
        calls.append(unit_key)
        return _toy_stage(p, gamma, unit_key)

    with pytest.raises(RuntimeError, match="killed"):
        t_grid(out, p0, gammas, failing, lambda x: x, chunk=2, log=lambda s: None)
    assert unit_sidecar(out).exists()
    logs, resumed = [], []

    def stage(p, gamma, unit_key=None):
        resumed.append(unit_key)
        return _toy_stage(p, gamma, unit_key)

    got = t_grid(out, p0, gammas, stage, lambda x: x, chunk=2, log=logs.append)
    assert resumed == ["r2-4-s1", "r4-5-s0", "r4-5-s1"] and "resuming" in logs[0]
    for key in full:
        np.testing.assert_array_equal(got[key], full[key], err_msg=key)
    assert not unit_sidecar(out).exists()


def _lv_kernel_and_nll(num_steps=4, obs_every=2):
    from ode_uncertainty_tpu_torch import models, solvers
    from ode_uncertainty_tpu_torch.filters import SqrtEKF
    from ode_uncertainty_tpu_torch.inference import make_nll, make_obs_model, make_param_spec
    from ode_uncertainty_tpu_torch.ops import const_diag

    dt, m, sol = torch.float64, models.lotka_volterra(), solvers.rkf45(0.01)
    x0 = torch.tensor([[1.0, 1.0]], dtype=dt)
    gt = solvers.solve(sol, m, 0.0, x0, num_steps)
    idx = np.arange(obs_every, num_steps + 1, obs_every)
    ys = gt["x"].numpy()[idx].reshape(len(idx), -1)
    ys = ys + 0.1 * np.random.default_rng(0).standard_normal(ys.shape)
    obs = make_obs_model(np.eye(2), gt["t"].numpy()[idx], ys, 0.01, 0.0, 0.01, num_steps, dtype=dt, device="cpu")
    spec = make_param_spec(m.params, {k: (0.1, 5.0) for k in m.params},
                           {"alpha": True, "beta": True, "gamma": False, "delta": False}, dtype=dt, device="cpu")
    ekf = SqrtEKF(disable_cov_update=True)
    state0 = ekf.init_state(0.0, x0, const_diag(2, 1e-6, dt, "cpu"), 2)
    q = torch.eye(2, dtype=dt)
    args = (m, sol, ekf, spec, obs, state0, num_steps)
    return nll_kernel.make_nll_cuda(*args, q), make_nll(*args), q


def test_stage_optimizer_routes_agree():
    # the kernels' route (their plain versions on the CPU) and make_nll +
    # autograd give the same stage optimum
    kernel, nll, q = _lv_kernel_and_nll()
    p0 = torch.as_tensor(np.random.default_rng(4).uniform(0.2, 0.8, size=(3, 2)))
    by_kernel = make_stage_optimizer_host(None, q, nll_batched=kernel, max_iter=3, progress_every=0)(p0, 0.01)
    by_nll = make_stage_optimizer_host(nll, q, max_iter=3, progress_every=0)(p0, 0.01)
    np.testing.assert_allclose(by_kernel.x, by_nll.x, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(by_kernel.f, by_nll.f, rtol=1e-9)
    np.testing.assert_array_equal(by_kernel.n_fev, by_nll.n_fev)
    assert (by_kernel.iters > 0).all()


def test_stage_optimizer_rejects_what_is_not_ported():
    kernel, _, q = _lv_kernel_and_nll()
    # the mesh is ported (tests/test_torch_mesh_host.py); as in the reference,
    # it takes nll and not nll_batched
    with pytest.raises(ValueError, match="nll_batched and mesh are mutually exclusive"):
        make_stage_optimizer_host(None, q, nll_batched=kernel, mesh=object())
    with pytest.raises(ValueError, match="nll or nll_batched"):
        make_stage_optimizer_host(None, q)


def test_initial_restarts_from_a_seeded_generator():
    from ode_uncertainty_tpu_torch.inference import make_param_spec

    spec = make_param_spec({"a": 1.0, "b": 2.0}, {"a": (0.0, 2.0), "b": (0.0, 4.0)}, dtype=torch.float64, device="cpu")
    draws = initial_restarts({"num_random_runs": 5, "seed": 3}, spec, torch.float32)
    again = initial_restarts({"num_random_runs": 5, "seed": 3}, spec, torch.float32)
    assert draws.shape == (5, 2) and draws.dtype == torch.float32 and torch.equal(draws, again)
    assert not torch.equal(draws, initial_restarts({"num_random_runs": 5, "seed": 4}, spec, torch.float32))
    np.testing.assert_array_equal(initial_restarts({"num_random_runs": 0}, spec, torch.float64).numpy(), [[0.5, 0.5]])


def test_optimize_device_mode_is_not_ported(tmp_path):
    # optimizer_mode=device runs the device L-BFGS on the route the host
    # optimizer takes (tests/test_torch_device_cli.py holds it to JAX's CLI)
    from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment

    cfg = build_config(load_experiment("params/lotkavolterra2"),
                       {"device": "cpu", "optimizer_mode": "device", "output": str(tmp_path / "x.npz"),
                        "tN": 0.05, "num_random_runs": 0, "num_tempering_stages": 2, "lbfgs_maxiter": 2})
    res = optimize(cfg)
    assert res["optimizer_mode"] == "device" and res["route"] == "nll_fwd + nll_bwd kernels"
    assert res["params_optims"].shape == (1, 2, 2) and (res["num_lbfgs_iters"] <= 2).all()
    assert [u["dispatches"] for u in res["units"]] and all(u["widest"] == 1 for u in res["units"])


def _run(args, cwd, home, timeout=300):
    env = {
        "PYTHONPATH": str(REPO),
        "JAX_PLATFORMS": "cpu",
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "HOME": str(home),
    }
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                         cwd=cwd, timeout=timeout)
    assert out.returncode == 0, f"{args} failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout


def test_optimize_cli_matches_jax_cli(tmp_path):
    port_out, jax_out = tmp_path / "port.h5", tmp_path / "jax.h5"
    common = ["optimize", "--experiment", "params/lotkavolterra2", "--set", "tN=0.5",
              "--set", "num_random_runs=0", "--set", "num_tempering_stages=2",
              "--set", "lbfgs_maxiter=10", "--set", "float64=true"]
    stdout = _run(["-m", "ode_uncertainty_tpu_torch.run_parameter_estimation", *common,
                   "--set", "device=cpu", "--set", f"output={port_out}"], cwd=tmp_path, home=tmp_path)
    assert "nll_fwd + nll_bwd kernels" in stdout  # the kernels' route (plain versions on the CPU)
    _run(["run_parameter_estimation.py", *common, "--set", "platform=cpu",
          "--set", f"output={jax_out}"], cwd=REPO / "scripts", home=tmp_path)
    with h5py.File(port_out, "r") as got, h5py.File(jax_out, "r") as ref:
        assert sorted(got) == sorted(ref)
        for key in ("params_inits", "params_default", "params_name", "gammas",
                    "num_lbfgs_iters", "num_nll_evals", "num_nll_jac_evals"):
            np.testing.assert_array_equal(got[key][()], ref[key][()], err_msg=key)
        assert got["params_optims"].shape == (1, 2, 2)
        np.testing.assert_allclose(got["params_optims"][()], ref["params_optims"][()], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["nll_optims"][()], ref["nll_optims"][()], rtol=1e-8)
    assert not unit_sidecar(str(port_out)).exists()


_HYGIENE = textwrap.dedent(
    """
    import sys
    import numpy as np

    BLOCKED = ("jax", "jaxlib", "h5py", "yaml", "triton", "ode_uncertainty_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    from ode_uncertainty_tpu_torch import models, solvers
    from ode_uncertainty_tpu_torch.run_parameter_estimation import main
    sol = solvers.solve(solvers.rkf45(0.01), models.lotka_volterra(), 0.0,
                        torch.tensor([[1.0, 1.0]], dtype=torch.float64), 30)
    np.savez(sys.argv[1] + "/obs.npz", t=sol["t"].numpy(), x=sol["x"].numpy())
    main(["optimize", "--experiment", "params/lotkavolterra2", "--set", "device=cpu",
          "--set", "tN=0.3", "--set", "num_random_runs=2", "--set", "num_tempering_stages=2",
          "--set", "lbfgs_maxiter=2", "--set", f"y_path={sys.argv[1]}/obs.npz",
          "--set", f"output={sys.argv[1]}/out.npz"])
    out = np.load(sys.argv[1] + "/out.npz")
    assert out["params_optims"].shape == (2, 2, 2) and np.isfinite(out["nll_optims"]).all()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("optimized without", ", ".join(BLOCKED))
    """
)


def test_optimize_imports_no_jax_h5py_yaml_or_the_jax_package(tmp_path):
    stdout = _run(["-c", _HYGIENE, str(tmp_path)], cwd=REPO, home=tmp_path)
    assert "optimized without" in stdout
