"""Filter negative log-likelihood of ODE parameters (port of
``ode_uncertainty_tpu/inference/nll.py``, uniform-grid fast path only).

Runs the square-root EKF over the time grid with a batch of candidate
parameters and sums the innovation Gaussian NLL at every observation. The
general flag/index-map loop and the filter-free baseline NLL are not ported
yet: :func:`make_nll` raises for a configuration that needs them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ode_uncertainty_tpu_torch.filters.sqrt_ekf import EKFState, SqrtEKF
from ode_uncertainty_tpu_torch.inference.observations import ObsModel
from ode_uncertainty_tpu_torch.inference.params import ParamSpec
from ode_uncertainty_tpu_torch.models.base import ODEModel
from ode_uncertainty_tpu_torch.ops.nll_kernel import detect_uniform
from ode_uncertainty_tpu_torch.ops.sqrt_linalg import nll_gaussian_sqrt


def make_nll(
    model: ODEModel,
    solver,
    ekf: SqrtEKF,
    spec: ParamSpec,
    obs: ObsModel,
    state0: EKFState,
    num_steps: int,
    x0_raw: Optional[torch.Tensor] = None,
    initial_state_parametrized: bool = False,
    parameter_sensitivity: bool = False,
) -> Callable:
    """Returns ``nll(p_norm_opt [..., P_opt], q_sqrt [n, n], gamma_sqrt []) -> [...]``.

    Observations must land every d steps with sequential rows; the time loop
    is then one span of ``first + 1`` predicts and a correct, followed by
    ``n_obs - 1`` spans of ``d`` predicts and a correct. Steps after the last
    observation add nothing to the NLL and are not run.
    """
    del num_steps  # the uniform grid fixes the horizon that matters
    uniform = detect_uniform(obs)
    if uniform is None:
        raise NotImplementedError(
            "the port's make_nll covers uniformly spaced, row-ordered observations only"
        )
    if parameter_sensitivity:
        raise NotImplementedError("parameter_sensitivity is not ported yet")
    first, d, n_obs = uniform
    predict = ekf.make_predict(solver, model.rhs)
    correct = ekf.make_correct()

    def nll(p_norm_opt: torch.Tensor, q_sqrt: torch.Tensor, gamma_sqrt) -> torch.Tensor:
        params = spec.to_params(p_norm_opt)
        batch = p_norm_opt.shape[:-1]
        x0 = state0.x
        if initial_state_parametrized:
            if x0_raw is None:
                raise ValueError("initial_state_parametrized requires x0_raw")
            x0 = model.build_initial_value(x0_raw, params).to(x0.dtype)
        state = state0.replace(x=x0.expand(*batch, *x0.shape[-2:]))

        def predict_span(s, count):
            for _ in range(count):
                s = predict(s, params, q_sqrt, gamma_sqrt)
            return s

        def correct_at(s, j):
            y = obs.ys[j]
            s2 = correct(s, obs.H, y, obs.R_sqrt)
            return s2, nll_gaussian_sqrt(y, s2.y_hat, s2.S_sqrt)

        state, total = correct_at(predict_span(state, first + 1), 0)
        for j in range(1, n_obs):
            state, nlg = correct_at(predict_span(state, d), j)
            total = total + nlg
        return total

    return nll
