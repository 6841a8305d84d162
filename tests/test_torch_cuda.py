"""The nll_fwd CUDA kernel against its plain PyTorch version, on the card.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py``.
Without a card it skips (the kernel has no CPU mode; ``chip_smoke.py`` runs
it at full size). Tolerance: float64 rtol 1e-9; float32 rtol 2e-4 / atol
1e-4 against the float32 plain version.
"""

import numpy as np
import pytest
import torch

from ode_uncertainty_tpu_torch import models, solvers
from ode_uncertainty_tpu_torch.filters import SqrtEKF
from ode_uncertainty_tpu_torch.inference import make_obs_model, make_param_spec
from ode_uncertainty_tpu_torch.ops import const_diag, nll_kernel


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
