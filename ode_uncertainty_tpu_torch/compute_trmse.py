"""Trajectory RMSE of estimated parameters, the port's entry point
(counterpart of ``scripts/compute_trmse.py``): reads the last tempering
stage's estimates (``params_optims``) from an estimation's H5 or npz
output, re-simulates each run's trajectory, prints the tRMSE mean and std
against the trajectory at the model's default parameters, and appends
``trmse_values``, ``trmse_mean`` and ``trmse_std`` to that file.

Usage:
  python -m ode_uncertainty_tpu_torch.compute_trmse --experiment params/lotkavolterra2 \\
      --set parameter_estimates_input=out.npz [--set device=cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ode_uncertainty_tpu_torch._common import build_x0, num_steps_of
from ode_uncertainty_tpu_torch.inference import make_param_spec, make_trmse_evaluator
from ode_uncertainty_tpu_torch.utils.config import apply_runtime_config, config_cli
from ode_uncertainty_tpu_torch.utils.io import load_data, store_data


def run(cfg) -> dict:
    """tRMSE of the estimates named by ``cfg``; appends and returns them."""
    rt = apply_runtime_config(cfg)
    dtype, device = rt["dtype"], rt["device"]
    src = cfg.get("parameter_estimates_input") or cfg.get("output")
    if src is None:
        raise ValueError("parameter_estimates_input (or output) is required")
    params_est = np.asarray(load_data(src)["params_optims"])
    if params_est.ndim == 3:  # [runs, stages, P] -> final stage
        params_est = params_est[:, -1, :]

    model = cfg["ode_builder"]
    solver = cfg["solver_builder"]
    x0_raw, _ = build_x0(cfg, model, dtype, device)
    spec = make_param_spec(
        model.params, cfg.get("params_range", {}), cfg.get("params_optimized"), dtype=dtype, device=device
    )
    evaluate = make_trmse_evaluator(model, solver, spec, cfg.get("t0", 0.0), x0_raw, num_steps_of(cfg, solver))
    vals, mean, std = (t.cpu().numpy() for t in evaluate(torch.as_tensor(params_est, dtype=dtype, device=device)))
    n_fin = int(np.isfinite(vals).sum())
    suffix = "" if n_fin == len(vals) else f" ({n_fin}/{len(vals)} runs finite)"
    print(f"tRMSE={float(mean):.2f}±{float(std):.2f}{suffix}", flush=True)
    results = {
        "trmse_values": np.asarray(vals, np.float64),
        "trmse_mean": np.float64(mean),
        "trmse_std": np.float64(std),
    }
    store_data(results, src, mode="a")
    return results


def main(argv=None) -> None:
    run(config_cli("Trajectory RMSE of estimated parameters (PyTorch/CUDA port)", argv=argv))


if __name__ == "__main__":
    main()
