"""The filter steps that ``utils/scan.scan_plan`` replays as CUDA graphs (a
square-root EKF over Lotka-Volterra, with a predict-only and a
predict-and-correct kind of step) against the same steps run eagerly, on
the card: float64, each saved step within 1e-12 of its largest element.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_cuda_graphs.py``. Without a card it skips (CUDA graphs have
no CPU mode; ``chip_smoke.py`` runs the graphed paths at full size).
"""

import numpy as np
import pytest
import torch

from ode_uncertainty_tpu_torch import models, solvers
from ode_uncertainty_tpu_torch.filters import SqrtEKF
from ode_uncertainty_tpu_torch.inference import make_obs_model
from ode_uncertainty_tpu_torch.ops import const_diag
from ode_uncertainty_tpu_torch.utils.scan import scan_plan


@pytest.mark.cuda
def test_filter_steps_replayed_as_cuda_graphs_match_the_eager_steps():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode (chip_smoke.py runs the graphed paths)")
    dtype, steps = torch.float64, 100
    m, sol = models.lotka_volterra(), solvers.rkf45(0.01)
    x0 = torch.tensor([[1.0, 1.0]], dtype=dtype, device="cuda")
    gt = solvers.solve(sol, m, 0.0, x0, steps)
    idx = np.arange(5, steps + 1, 5)
    ys = gt["x"].cpu().numpy()[idx].reshape(len(idx), -1)
    ys = ys + np.sqrt(0.1) * np.random.default_rng(0).standard_normal(ys.shape)
    obs = make_obs_model(np.eye(2), gt["t"].cpu().numpy()[idx], ys, 0.1, 0.0, 0.01, steps, dtype=dtype, device="cuda")
    ekf = SqrtEKF()
    predict, correct = ekf.make_predict(sol, m.rhs), ekf.make_correct(unrolled=True)
    q_sqrt, gamma_sqrt = const_diag(2, 1.0, dtype, "cuda"), torch.tensor(0.1, dtype=dtype, device="cuda")
    flags, rows = obs.flags.cpu().tolist(), obs.index_map.cpu().tolist()

    def step(state, kind, *y):
        state = predict(state, m.params, q_sqrt, gamma_sqrt)
        return correct(state, obs.H, y[0], obs.R_sqrt) if kind == "correct" else state

    def plan(i):
        return ("correct", (obs.ys[rows[i]],)) if flags[i] else ("predict", ())

    state0 = ekf.init_state(0.0, x0, const_diag(2, 1e-3, dtype, "cuda"), obs.obs_dim)
    with torch.no_grad():
        graphed = scan_plan(step, plan, state0, steps, save_every=10, graphs=True)[1]
        eager = scan_plan(step, plan, state0, steps, save_every=10, graphs=False)[1]
    for key in ("x", "eps", "P_sqrt", "y_hat", "S_sqrt"):
        g, e = getattr(graphed, key).cpu().numpy(), getattr(eager, key).cpu().numpy()
        assert g.shape == e.shape == (steps // 10 + 1, *getattr(state0, key).shape), key
        largest = np.abs(e).reshape(len(e), -1).max(axis=1)
        gap = np.abs(g - e).reshape(len(e), -1).max(axis=1)
        assert np.all(gap <= 1e-12 * largest), (key, gap, largest)
