"""Calibration comparison: static process-noise sweep vs local-error noise
(port of ``ode_uncertainty_tpu/inference/calibrate.py``).

Computes the filter's mean innovation NLL for a sweep of Conrad-style fixed
noise levels and for the local-error covariance update. The noise levels are
one leading batch dimension of the filter state (the JAX package ``vmap``s
over them), so the sweep is one pass over the time grid (on the GPU, one
CUDA-graph replay a step: ``utils/scan.scan_plan``).

NLL convention: per-step **mean** over the whole grid (steps without an
observation count 0) with NaN-to-zero sanitation, unlike the estimation
objective's sum.
"""

from __future__ import annotations

import torch

from ode_uncertainty_tpu_torch.filters.sqrt_ekf import EKFState, SqrtEKF
from ode_uncertainty_tpu_torch.inference.observations import ObsModel
from ode_uncertainty_tpu_torch.models.base import ODEModel
from ode_uncertainty_tpu_torch.ops.sqrt_linalg import nll_gaussian_sqrt
from ode_uncertainty_tpu_torch.utils.scan import scan_plan


def make_calibration(
    ekf: SqrtEKF, solver, model: ODEModel, obs: ObsModel, state0: EKFState, num_steps: int
):
    """Returns ``calibrate(params, noise_levels [K]) -> (nll_static [K],
    nll_local_error [])``."""
    predict_static = ekf.make_predict_static(solver, model.rhs)
    predict_local = ekf.make_predict(solver, model.rhs)
    correct = ekf.make_correct(unrolled=True)
    flags = obs.flags.cpu().tolist()
    rows = obs.index_map.cpu().tolist()

    def mean_nll(predict_one, state):
        """Mean over the grid of the innovation NLL (0 at a step without an
        observation), accumulated step by step in the carry."""

        def step(carry, kind, *y):
            state, total = carry
            state = predict_one(state)
            if kind == "correct":
                state = correct(state, obs.H, y[0], obs.R_sqrt)
                total = total + torch.nan_to_num(nll_gaussian_sqrt(y[0], state.y_hat, state.S_sqrt, unrolled=True))
            return state, total

        def plan(idx):
            return ("correct", (obs.ys[rows[idx]],)) if flags[idx] else ("predict", ())

        total0 = torch.zeros_like(state.x[..., 0, 0])
        (_, total), _ = scan_plan(step, plan, (state, total0), num_steps, save_every=max(num_steps, 1))
        return total / num_steps

    def lanes(k: int) -> EKFState:
        """state0 repeated over k noise levels."""
        return EKFState(
            t=state0.t,
            **{f: getattr(state0, f).expand(k, *getattr(state0, f).shape).clone()
               for f in ("x", "eps", "P_sqrt", "y_hat", "S_sqrt")},
        )

    def calibrate(params, noise_levels: torch.Tensor):
        nll_static = mean_nll(lambda s: predict_static(s, params, noise_levels), lanes(noise_levels.shape[0]))
        n = state0.x.numel()
        zero_q = torch.zeros((n, n), dtype=state0.x.dtype, device=state0.x.device)
        zero_g = torch.zeros((), dtype=state0.x.dtype, device=state0.x.device)
        nll_local = mean_nll(lambda s: predict_local(s, params, zero_q, zero_g), state0)
        return nll_static, nll_local

    return calibrate
