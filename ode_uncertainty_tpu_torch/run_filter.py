"""Probabilistic ODE solution: a filter's trajectory over the time grid
(counterpart of ``scripts/run_filter.py``; the ``ekf_trajectory/*`` and
``pf_trajectory/*`` families).

Runs the config's filter, correcting against the observations of ``y_path``
when it is set (prediction only otherwise), and stores the trajectory under
the JAX script's keys:

  * ``ParticleFilter``: ``t``, ``x``, ``eps`` (particles on axis 1; the
    noise from a ``torch.Generator`` on the run's device seeded with
    ``seed``);
  * ``SqrtEKF`` / ``SqrtUKF``: the state's fields plus the constant noise
    configuration ``Q_sqrt``, ``gamma_sqrt`` and ``R_sqrt``;
    ``use_static_cov_fn`` switches the square-root EKF to the fixed-noise
    baseline at the scale of the filter's ``static_cov_update``;
  * ``DenseEKF`` / ``UKF``: the dense state's fields;
  * ``GMMSqrtEKF``: the whole component bank.

The filter runs without autograd, which linearizes an explicit step in
reverse mode (``filters/sqrt_ekf.py``). Output: H5, or ``.npz`` for a path
with that suffix.

Usage:
  python -m ode_uncertainty_tpu_torch.run_filter --experiment ekf_trajectory/rkf45/lotkavolterra \\
      [--set device=cpu] [--set float64=true] [--set tN=1] [--set output=out.npz] \\
      [--set 'filter_builder={"class_path": "UKF_SQRT"}']
"""

from __future__ import annotations

import dataclasses

import torch

from ode_uncertainty_tpu_torch._common import build_p0_sqrt, build_x0, load_observations, num_steps_of
from ode_uncertainty_tpu_torch.filters import UKF, DenseEKF, GMMSqrtEKF, ParticleFilter, SqrtEKF, SqrtUKF
from ode_uncertainty_tpu_torch.inference import (
    make_dense_run,
    make_ekf_run,
    make_ekf_run_static,
    make_gmm_run,
    make_pf_run,
)
from ode_uncertainty_tpu_torch.utils.config import apply_runtime_config, config_cli
from ode_uncertainty_tpu_torch.utils.io import store_data


def run(cfg) -> dict:
    """Runs the filter of ``cfg``; stores and returns the trajectory."""
    rt = apply_runtime_config(cfg)
    dtype, device = rt["dtype"], rt["device"]
    model = cfg["ode_builder"]
    solver = cfg["solver_builder"]
    flt = cfg["filter_builder"]
    num_steps = num_steps_of(cfg, solver)
    save_every = cfg.get("save_interval", 1)
    t0 = cfg.get("t0", 0.0)
    _, x0 = build_x0(cfg, model, dtype, device)
    n = x0.numel()
    obs, has_obs = load_observations(cfg, solver, num_steps, n, dtype, device)
    zero_q = torch.zeros((n, n), dtype=dtype, device=device)
    zero_g = torch.zeros((), dtype=dtype, device=device)

    with torch.no_grad():
        if isinstance(flt, ParticleFilter):
            gen = torch.Generator(device=device).manual_seed(cfg.get("seed", 7))
            _, traj = make_pf_run(flt, solver, model, num_steps, save_every)(flt.init_state(t0, x0), model.params, gen)
            out = {"t": traj.t, "x": traj.x, "eps": traj.eps}
        elif isinstance(flt, (SqrtEKF, SqrtUKF)):
            state0 = flt.init_state(t0, x0, build_p0_sqrt(cfg, n, dtype, device), obs.obs_dim)
            if cfg.get("use_static_cov_fn", False):
                scale = getattr(getattr(flt, "static_cov_update", None), "scale", 1.0)
                sigma = torch.as_tensor(scale, dtype=dtype, device=device)
                _, traj = make_ekf_run_static(flt, solver, model, num_steps, save_every)(state0, model.params, sigma, obs)
            else:
                _, traj = make_ekf_run(flt, solver, model, num_steps, save_every)(
                    state0, model.params, zero_q, zero_g, obs)
            out = dataclasses.asdict(traj)
            # constant noise configuration, stored for the reference schema
            out.update(Q_sqrt=zero_q, gamma_sqrt=zero_g, R_sqrt=obs.R_sqrt)
        elif isinstance(flt, (DenseEKF, UKF)):
            p0_sqrt = build_p0_sqrt(cfg, n, dtype, device)
            state0 = flt.init_state(t0, x0, p0_sqrt @ p0_sqrt.T, obs.obs_dim)
            _, traj = make_dense_run(flt, solver, model, num_steps, save_every)(state0, model.params, zero_q, zero_g, obs)
            out = dataclasses.asdict(traj)
        elif isinstance(flt, GMMSqrtEKF):
            state0 = flt.init_state(t0, x0, build_p0_sqrt(cfg, n, dtype, device))
            _, traj = make_gmm_run(flt, solver, model, num_steps, save_every)(state0, model.params, zero_q, zero_g, obs)
            out = dataclasses.asdict(traj)
        else:
            raise TypeError(f"Unsupported filter: {type(flt)}")

    store_data(out, cfg["output"])
    print(f"wrote trajectory ({num_steps} steps, obs={has_obs}, {type(flt).__name__}, {device}) "
          f"-> {cfg['output']}", flush=True)
    return out


def main(argv=None) -> None:
    run(config_cli("Probabilistic ODE solve (filter trajectory; PyTorch/CUDA port)", argv=argv))


if __name__ == "__main__":
    main()
