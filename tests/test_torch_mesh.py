"""The port's restart sharding (``parallel/mesh.py`` and the host L-BFGS's
``mesh=``) against the JAX package's ``ode_uncertainty_tpu.parallel`` on its
eight virtual CPU devices, the port on a mesh of eight ``cpu`` devices.

The rig is tests/test_parallel.py's (Lotka-Volterra, RKF45 steps of 0.05,
an observation every 10 steps, alpha and beta optimized, float64) cut from
100 steps to 20, and the optimizers' iteration limits from 15 and 12 to 4
and 6: on the CPU a value-and-gradient call of the port's objective costs
~0.2 s at 20 steps whatever its width, and a mesh of eight ``cpu`` devices
makes eight calls a dispatch, one after another; JAX's compiles of the
sharded programs take ~50 s of this file besides. The port's objective is
the NLL kernels' wrapper (their plain versions on the CPU), built once per
device by the sharded builders. tests/test_torch_mesh_host.py holds the
host optimizer's ``mesh=`` and the sharded landscape on the same rig.

Tolerances: against JAX, values at rtol 1e-9 and the optimizers' counters
equal; against the port's unsharded functions, bit for bit (each lane's NLL
depends on its own row alone).
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.filters import SqrtEKF as JEKF
from ode_uncertainty_tpu.inference import make_nll as j_make_nll
from ode_uncertainty_tpu.inference import make_obs_model as j_obs
from ode_uncertainty_tpu.inference import make_param_spec as j_spec
from ode_uncertainty_tpu.ops import const_diag as j_const_diag
from ode_uncertainty_tpu.parallel import device_mesh as j_device_mesh
from ode_uncertainty_tpu.parallel import make_sharded_tempered_estimator as j_sharded_estimator
from ode_uncertainty_tpu.parallel import shard_restarts as j_shard_restarts
from ode_uncertainty_tpu_torch.inference import make_stage_optimizer_host, make_tempered_estimator
from ode_uncertainty_tpu_torch.ops import nll_kernel
from ode_uncertainty_tpu_torch.parallel import (
    device_mesh,
    make_sharded_tempered_estimator,
    replicated,
    shard_restarts,
)
from ode_uncertainty_tpu_torch.utils.carry import rig_from_numpy

RTOL = 1e-9
MAX_ITER = 4  # the estimator's (15 in tests/test_parallel.py)
HOST_MAX_ITER = 6  # the host optimizer's (12 there; tests/test_torch_mesh_host.py)
NUM_STEPS = 20
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def rigs():
    """The JAX rig of tests/test_parallel.py and the port's, from its values."""
    m, h = jm.lotka_volterra(), 0.05
    sol = js.rkf45(step_size=h)
    x0 = jnp.array([[1.0, 1.0]])
    gt = js.solve(sol, m, 0.0, x0, NUM_STEPS)
    idx = np.arange(10, NUM_STEPS + 1, 10)
    ys = np.asarray(gt["x"])[idx].reshape(len(idx), -1)
    obs = j_obs(np.eye(2), np.asarray(gt["t"])[idx], ys, 0.01, 0.0, h, NUM_STEPS, dtype=jnp.float64)
    spec = j_spec(m.params, {k: (0.1, 5.0) for k in m.params},
                  {"alpha": True, "beta": True, "gamma": False, "delta": False}, dtype=jnp.float64)
    ekf = JEKF(disable_cov_update=True)
    state0 = ekf.init_state(0.0, x0, j_const_diag(2, 1e-6), 2)
    mask = np.zeros(spec.num_full, bool)
    mask[np.asarray(spec.opt_indices)] = True
    values = {
        "model": m.name, "params": {k: np.array(v) for k, v in m.params.items()}, "tableau": "rkf45", "h": h,
        "num_steps": NUM_STEPS, "t0": 0.0, "disable_cov_update": True, "spec_keys": spec.keys,
        "spec_shapes": spec.shapes, "defaults": np.asarray(spec.defaults_flat), "mins": np.asarray(spec.mins_flat),
        "maxs": np.asarray(spec.maxs_flat), "opt_mask": mask, "x0": np.asarray(state0.x),
        "P0_sqrt": np.asarray(state0.P_sqrt), "H": np.asarray(obs.H), "R_sqrt": np.asarray(obs.R_sqrt),
        "q_sqrt": np.eye(2), "ys": np.asarray(obs.ys), "flags": np.asarray(obs.flags),
        "index_map": np.asarray(obs.index_map),
    }

    def nll_on(device):
        """The port's objective on ``device``: the kernels' wrapper of a rig
        built there."""
        rig = rig_from_numpy(values, device=device, dtype=torch.float64)
        kern = nll_kernel.make_nll_cuda(rig.model, rig.solver, rig.ekf, rig.spec, rig.obs, rig.state0,
                                        rig.num_steps, rig.q_sqrt, accumulate_time=True)
        return lambda p, q_sqrt, gamma_sqrt: kern(p, gamma_sqrt)

    port_spec = rig_from_numpy(values, device="cpu", dtype=torch.float64).spec
    return {"jax": (spec, j_make_nll(m, sol, ekf, spec, obs, state0, NUM_STEPS)), "port": (port_spec, nll_on)}


def test_sharded_estimator_matches_jax_and_the_unsharded_one(rigs):
    (jspec, jnll), (spec, nll_on) = rigs["jax"], rigs["port"]
    p0 = np.asarray(jspec.sample_norm(random.key(0), 16), np.float64)
    gammas = np.array([1e-2, 0.0])
    jq = jnp.eye(2, dtype=jnp.float64)
    jmesh = j_device_mesh(num_devices=8)
    ref = j_sharded_estimator(jnll, jspec, jq, jmesh, max_iter=MAX_ITER, tol=1e-8)(j_shard_restarts(jnp.asarray(p0), jmesh),
                                                                             jnp.asarray(gammas))
    q = torch.eye(2, dtype=torch.float64)
    got = make_sharded_tempered_estimator(nll_on, spec, q, device_mesh(devices=CPU8), max_iter=MAX_ITER, tol=1e-8)(
        torch.as_tensor(p0), torch.as_tensor(gammas))
    nll = nll_on(torch.device("cpu"))
    plain = make_tempered_estimator(lambda p, gs: nll(p, q, gs), spec, max_iter=MAX_ITER, tol=1e-8)(
        torch.as_tensor(p0), torch.as_tensor(gammas))
    assert got.params_optims.shape == (16, 2, 2) and (got.num_lbfgs_iters > 0).all()
    for field in got._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(plain, field), err_msg=field)
    np.testing.assert_allclose(got.params_optims, np.asarray(ref.params_optims), rtol=RTOL)
    np.testing.assert_allclose(got.nll_optims, np.asarray(ref.nll_optims), rtol=RTOL)
    np.testing.assert_allclose(got.params_inits, np.asarray(ref.params_inits), rtol=1e-15)
    for field in ("num_lbfgs_iters", "num_nll_evals"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(ref, field)), err_msg=field)


def test_shard_restarts_places_leading_axis():
    mesh = device_mesh(devices=CPU8)
    x = torch.arange(32.0).reshape(32, 1)
    tree = {"x": x, "pair": (x[:, 0].numpy(), "label")}
    shards = shard_restarts(tree, mesh)
    assert len(shards) == 8 and [s["x"].device for s in shards] == list(mesh.devices)
    assert all(s["x"].shape == (4, 1) and s["pair"][1] == "label" for s in shards)
    torch.testing.assert_close(torch.cat([s["x"] for s in shards]), x, rtol=0, atol=0)
    np.testing.assert_array_equal(np.concatenate([s["pair"][0] for s in shards]), x[:, 0].numpy())
    # replicated data: one copy per distinct device, shared by its shards
    copies = replicated(mesh)(torch.eye(2))
    assert len(copies) == 8 and all(c is copies[0] for c in copies)
    assert mesh.distinct == (torch.device("cpu"),) and mesh.axis_name == "restarts"


def test_mesh_errors():
    mesh = device_mesh(devices=[torch.device("cpu")] * 3)
    with pytest.raises(ValueError, match="divide evenly"):
        shard_restarts(torch.zeros(10, 2), mesh)
    found = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"asked for {found + 1} CUDA devices, found {found}"):
        device_mesh(num_devices=found + 1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_stage_optimizer_host(lambda dev: None, torch.eye(2), nll_batched=lambda p, gs: p.sum(-1), mesh=mesh)


def test_launch_counts_survive_threads():
    # more threads than cores, a short switch interval: a lost update in the
    # launch counters shows as a count below the number of calls
    calls, threads = 2000, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        nll_kernel.reset_launches()
        workers = [threading.Thread(target=lambda: [nll_kernel.count_launch("nll_bwd") for _ in range(calls)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
        assert nll_kernel.launches == {"nll_fwd": 0, "nll_bwd": calls * threads}
    finally:
        sys.setswitchinterval(old)
        nll_kernel.reset_launches()
