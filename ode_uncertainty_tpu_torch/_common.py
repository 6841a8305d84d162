"""Shared entry-point plumbing (port of ``scripts/_common.py``): the step
count, the initial state, the initial covariance sqrt and the observation
model of a config.

Precision and device come from ``utils/config.apply_runtime_config``
(``float64``, ``device``). The JAX scripts' startup run-lock check and
compilation cache have no counterpart here (the port's ``utils/runlock.py``
is not called by the entry points).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ode_uncertainty_tpu_torch.inference.observations import ObsModel, empty_obs_model, make_obs_model
from ode_uncertainty_tpu_torch.ops.sqrt_linalg import const_diag
from ode_uncertainty_tpu_torch.utils.config import parse_literal
from ode_uncertainty_tpu_torch.utils.io import load_data


def num_steps_of(cfg, solver) -> int:
    return int(math.ceil((cfg["tN"] - cfg.get("t0", 0.0)) / solver.h))


def build_x0(cfg, model, dtype, device):
    """``(x0_raw, x0)``: the config's x0 and the model's full initial state."""
    x0_raw = torch.as_tensor(parse_literal(cfg["x0"]), dtype=dtype, device=device)
    return x0_raw, model.build_initial_value(x0_raw, model.params).to(dtype)


def build_p0_sqrt(cfg, n: int, dtype, device) -> torch.Tensor:
    """Cholesky factor of the config's ``P0``, or 1e-12 * I without one."""
    p0 = cfg.get("P0")
    if p0 is None:
        return const_diag(n, 1e-12, dtype, device)
    return torch.linalg.cholesky(torch.as_tensor(parse_literal(p0), dtype=dtype, device=device))


def load_observations(cfg, solver, num_steps: int, n: int, dtype, device) -> tuple[ObsModel, bool]:
    """``(obs, has_obs)``: the observation model of the config's
    ``y_path``/``measurement_matrix``, or a prediction-only stub when either
    is absent."""
    y_path = cfg.get("y_path")
    mm = cfg.get("measurement_matrix")
    if y_path is None or mm is None:
        return empty_obs_model(n, num_steps, dtype=dtype, device=device), False
    data = load_data(y_path)
    obs = make_obs_model(
        np.asarray(parse_literal(mm), dtype=float),
        np.asarray(data["t"]),
        np.asarray(data["x"]),
        cfg.get("obs_noise_var", 1e-3),
        cfg.get("t0", 0.0),
        solver.h,
        num_steps,
        dtype=dtype,
        device=device,
    )
    return obs, True
