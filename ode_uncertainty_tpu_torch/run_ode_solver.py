"""Deterministic trajectory generation, ground truth and noisy observations
(counterpart of ``scripts/run_ode_solver.py``; the ``gt/*`` and
``noise_gt/*`` families).

Integrates the ODE with the config's fixed-step solver, adds Gaussian
observation noise of variance ``noise_var`` when it is positive (drawn from
a ``torch.Generator`` on the run's device seeded with ``seed``: the JAX
script's draws differ, their statistics do not), and writes ``t``, ``x`` and
``eps`` to ``output`` (H5, or ``.npz`` for a path with that suffix).

Usage:
  python -m ode_uncertainty_tpu_torch.run_ode_solver --experiment gt/lotkavolterra \\
      [--set device=cpu] [--set float64=true] [--set tN=1] [--set output=out.npz]
"""

from __future__ import annotations

import torch

from ode_uncertainty_tpu_torch._common import build_x0, num_steps_of
from ode_uncertainty_tpu_torch.solvers import make_solve_fn
from ode_uncertainty_tpu_torch.utils.config import apply_runtime_config, config_cli
from ode_uncertainty_tpu_torch.utils.io import store_data


def run(cfg) -> dict:
    """Solves ``cfg``; stores and returns the trajectory."""
    rt = apply_runtime_config(cfg)
    dtype, device = rt["dtype"], rt["device"]
    model = cfg["ode_builder"]
    solver = cfg["solver_builder"]
    num_steps = num_steps_of(cfg, solver)
    _, x0 = build_x0(cfg, model, dtype, device)

    with torch.no_grad():
        traj = make_solve_fn(solver, model, num_steps, cfg.get("save_interval", 1))(cfg.get("t0", 0.0), x0, model.params)
        noise_var = cfg.get("noise_var", 0.0)
        if noise_var > 0.0:
            gen = torch.Generator(device=device).manual_seed(cfg.get("seed", 7))
            noise = torch.randn(traj["x"].shape, generator=gen, dtype=dtype, device=device)
            traj["x"] = traj["x"] + noise_var**0.5 * noise

    store_data(traj, cfg["output"])
    print(f"wrote {traj['x'].shape[0]} states ({num_steps} steps, {device}) -> {cfg['output']}", flush=True)
    return traj


def main(argv=None) -> None:
    run(config_cli("Deterministic ODE solve (ground-truth generation; PyTorch/CUDA port)", argv=argv))


if __name__ == "__main__":
    main()
