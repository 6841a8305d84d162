"""The port's host L-BFGS with ``mesh=`` and its sharded NLL landscape
(``parallel/mesh.py``) against the JAX package's on its virtual CPU
devices, the port on meshes of ``cpu`` devices, on the rig of
tests/test_torch_mesh.py (its docstring gives the cuts). A dispatch width
that does not divide over the mesh (13 restarts over 4 devices) is padded
with copies of row 0, as in the reference.

Tolerances: against JAX, values at rtol 1e-9 and the optimizer's counters
equal; against the port's unsharded functions, bit for bit.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from ode_uncertainty_tpu.inference import make_nll_landscape as j_landscape
from ode_uncertainty_tpu.inference.lbfgs_host import make_stage_optimizer_host as j_stage_host
from ode_uncertainty_tpu.parallel import device_mesh as j_device_mesh
from ode_uncertainty_tpu.parallel import make_sharded_nll_landscape as j_sharded_landscape
from ode_uncertainty_tpu.parallel import shard_restarts as j_shard_restarts
from ode_uncertainty_tpu_torch.inference import make_nll_landscape, make_stage_optimizer_host
from ode_uncertainty_tpu_torch.parallel import device_mesh, make_sharded_nll_landscape
from test_torch_mesh import CPU8, HOST_MAX_ITER, RTOL, rigs  # noqa: F401 (a fixture)


@pytest.mark.parametrize("restarts, shards", [(20, 8), (13, 4)], ids=["20-over-8", "13-over-4"])
def test_sharded_host_optimizer_matches_jax_and_the_unsharded_one(rigs, restarts, shards):
    (jspec, jnll), (spec, nll_on) = rigs["jax"], rigs["port"]
    p0 = np.asarray(jspec.sample_norm(random.key(2), restarts), np.float64)
    jq = jnp.eye(2, dtype=jnp.float64)
    ref = j_stage_host(jnll, jq, max_iter=HOST_MAX_ITER, tol=1e-8, mesh=j_device_mesh(num_devices=shards),
                       progress_every=0)(p0, 1e-2)
    q = torch.eye(2, dtype=torch.float64)
    widths = []
    lock = threading.Lock()

    def counted_on(device):
        nll = nll_on(device)

        def counted(p, q_sqrt, gamma_sqrt):
            with lock:
                widths.append(p.shape[0])
            return nll(p, q_sqrt, gamma_sqrt)

        return counted

    mesh = device_mesh(devices=[torch.device("cpu")] * shards)
    got = make_stage_optimizer_host(counted_on, q, max_iter=HOST_MAX_ITER, tol=1e-8, mesh=mesh, progress_every=0)(p0, 1e-2)
    nll = nll_on(torch.device("cpu"))
    plain = make_stage_optimizer_host(None, q, nll_batched=lambda p, gs: nll(p, q, gs), max_iter=HOST_MAX_ITER, tol=1e-8,
                                      progress_every=0)(torch.as_tensor(p0), 1e-2)
    for field in got._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(plain, field), err_msg=field)
    np.testing.assert_allclose(got.x, ref.x, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(got.f, ref.f, rtol=RTOL)
    np.testing.assert_array_equal(got.n_fev, ref.n_fev)
    np.testing.assert_array_equal(got.iters, ref.iters)
    # every dispatch is split into equal shards: the padded width over the mesh
    assert widths and set(widths) <= {-(-w // shards) for w in range(1, restarts + 1)}
    assert len(widths) % shards == 0 and got.iters.max() > 1


def test_sharded_landscape_matches_jax_and_the_unsharded_one(rigs):
    (jspec, jnll), (spec, nll_on) = rigs["jax"], rigs["port"]
    axis = np.linspace(0.0, 1.0, 4)
    grid = np.stack(np.meshgrid(axis, axis, indexing="ij"), -1).reshape(-1, 2)
    gammas = np.array([1e-2, 1e-4, 0.0])
    jq = jnp.eye(2, dtype=jnp.float64)
    jmesh = j_device_mesh(num_devices=8)
    ref = np.asarray(j_sharded_landscape(jnll, jq, jmesh)(j_shard_restarts(jnp.asarray(grid), jmesh),
                                                          jnp.asarray(gammas)))
    q = torch.eye(2, dtype=torch.float64)
    got = make_sharded_nll_landscape(nll_on, q, device_mesh(devices=CPU8))(torch.as_tensor(grid),
                                                                           torch.as_tensor(gammas))
    plain = make_nll_landscape(nll_on(torch.device("cpu")), q, batch_size=5)(torch.as_tensor(grid),
                                                                             torch.as_tensor(gammas))
    assert got.shape == (3, 16) and got.device.type == "cpu"
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL)
    np.testing.assert_allclose(ref, np.asarray(j_landscape(jnll, jq)(jnp.asarray(grid), jnp.asarray(gammas))),
                               rtol=1e-12)
