"""Trajectory RMSE of estimated parameters (port of
``ode_uncertainty_tpu/inference/trmse.py``).

Re-simulates the trajectory at each run's estimated parameters and compares
it with the trajectory at the model's default ("true") parameters. The runs
are a leading batch axis of one solve.
"""

from __future__ import annotations

import torch

from ode_uncertainty_tpu_torch.inference.params import ParamSpec
from ode_uncertainty_tpu_torch.models.base import ODEModel


def trmse(traj_true: torch.Tensor, traj_est: torch.Tensor) -> torch.Tensor:
    """sqrt(mean_t ||x_est(t) - x_true(t)||_2^2); the leading axis is time,
    ``traj_est`` may carry batch axes after it: [T, ..., N, D] -> [...]."""
    d = traj_est - traj_true.reshape(traj_true.shape[:1] + (1,) * (traj_est.dim() - traj_true.dim())
                                     + traj_true.shape[1:])
    d = d.reshape(*d.shape[:-2], -1)
    return torch.sqrt(torch.mean(torch.sum(d * d, dim=-1), dim=0))


def make_trmse_evaluator(model: ODEModel, solver, spec: ParamSpec, t0, x0_raw: torch.Tensor, num_steps: int):
    """Returns ``evaluate(params_phys [R, P_opt]) -> (trmses [R], mean, std)``
    against the model's default parameters; the mean and the std are over
    the finite runs (diverged runs re-simulate to non-finite
    trajectories)."""
    dtype, device = x0_raw.dtype, x0_raw.device

    def unroll_x(params, batch):
        x = model.build_initial_value(x0_raw, params).to(dtype)
        x = x.expand(*batch, *x.shape[-2:])
        t0_t = torch.as_tensor(t0, dtype=dtype, device=device)
        xs = []
        for idx in range(num_steps):
            # the step index, as the reference: t0 + idx * h
            x, _ = solver.step(model.rhs, params, t0_t + idx * solver.h, x)
            xs.append(x)
        return torch.stack(xs)

    @torch.no_grad()
    def evaluate(params_phys: torch.Tensor):
        truth = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in model.params.items()}
        traj_true = unroll_x(truth, ())
        params = spec.to_params(spec.physical_to_opt(params_phys.to(dtype)))
        vals = trmse(traj_true, unroll_x(params, params_phys.shape[:-1]))
        finite = torch.isfinite(vals)
        n = torch.clamp(finite.sum(), min=1)
        mean = torch.where(finite, vals, 0.0).sum() / n
        var = torch.where(finite, (vals - mean) ** 2, 0.0).sum() / torch.clamp(n - 1, min=1)
        return vals, mean, torch.sqrt(var)

    return evaluate
