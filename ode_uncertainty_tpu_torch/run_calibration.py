"""Calibration comparison: static noise sweep vs local-error covariance
(counterpart of ``scripts/run_calibration.py``; the ``calibration/*``
family).

Computes the square-root EKF's mean innovation NLL across
``num_noise_levels`` static process-noise levels (Conrad baseline, log-spaced
from 10^min_noise_log to 10^max_noise_log) and for the local-error update
("ours"), against the ground truth of ``y_path``. The levels are one batch
dimension of the filter (``inference/calibrate.py``). Writes
``noise_levels``, ``nll_conrad`` and ``nll_ours`` to ``output`` (H5, or
``.npz`` for a path with that suffix).

Usage:
  python -m ode_uncertainty_tpu_torch.run_calibration --experiment calibration/rkf45/lotkavolterra \\
      [--set y_path=ode_uncertainty_tpu_torch/data/gt_lotkavolterra.npz] \\
      [--set device=cpu] [--set float64=true] [--set tN=1] [--set output=out.npz]
"""

from __future__ import annotations

import numpy as np
import torch

from ode_uncertainty_tpu_torch._common import build_p0_sqrt, build_x0, load_observations, num_steps_of
from ode_uncertainty_tpu_torch.inference import make_calibration
from ode_uncertainty_tpu_torch.utils.config import apply_runtime_config, config_cli
from ode_uncertainty_tpu_torch.utils.io import store_data


def run(cfg) -> dict:
    """Calibrates ``cfg``; stores and returns the results."""
    rt = apply_runtime_config(cfg)
    dtype, device = rt["dtype"], rt["device"]
    model = cfg["ode_builder"]
    solver = cfg["solver_builder"]
    ekf = cfg["filter_builder"]
    num_steps = num_steps_of(cfg, solver)
    _, x0 = build_x0(cfg, model, dtype, device)
    n = x0.numel()
    obs, has_obs = load_observations(cfg, solver, num_steps, n, dtype, device)
    if not has_obs:
        raise ValueError("Calibration requires y_path (ground-truth observations)")

    state0 = ekf.init_state(cfg.get("t0", 0.0), x0, build_p0_sqrt(cfg, n, dtype, device), obs.obs_dim)
    calibrate = make_calibration(ekf, solver, model, obs, state0, num_steps)
    levels = torch.logspace(
        cfg.get("min_noise_log", -3.0),
        cfg.get("max_noise_log", 1.0),
        cfg.get("num_noise_levels", 100),
        dtype=dtype,
        device=device,
    )
    with torch.no_grad():
        nll_static, nll_local = calibrate(model.params, levels)
    out = {
        "noise_levels": levels.cpu().numpy(),
        "nll_conrad": nll_static.cpu().numpy(),
        "nll_ours": nll_local.cpu().numpy(),
    }
    store_data(out, cfg["output"])
    print(
        f"calibration: {levels.shape[0]} levels, {num_steps} steps ({device}); best static NLL "
        f"{float(np.min(out['nll_conrad'])):.4f}, local-error NLL {float(out['nll_ours']):.4f} -> {cfg['output']}",
        flush=True,
    )
    return out


def main(argv=None) -> None:
    run(config_cli("Static-noise calibration sweep vs local-error covariance (PyTorch/CUDA port)", argv=argv))


if __name__ == "__main__":
    main()
