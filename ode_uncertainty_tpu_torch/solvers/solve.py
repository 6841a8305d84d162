"""Trajectory unroll (port of ``ode_uncertainty_tpu/solvers/solve.py``).

Time is derived from the integer step index (``t = t0 + idx * h``) rather
than accumulated, and the returned trajectory includes the initial state at
index 0, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch

from ode_uncertainty_tpu_torch.models.base import ODEModel, Params
from ode_uncertainty_tpu_torch.utils.scan import scan_save


def make_solve_fn(solver, model: ODEModel, num_steps: int, save_every: int = 1):
    """Returns ``(t0, x0, params) -> {"t", "x", "eps"}``.

    The trajectory has ``num_steps // save_every + 1`` entries including the
    initial state; ``eps`` at entry k is the local-error estimate of the step
    that produced that state (zeros at the initial entry).
    """
    h = solver.h
    chunks = num_steps // save_every

    def run(t0, x0: torch.Tensor, params: Params):
        t0 = torch.as_tensor(t0, dtype=x0.dtype, device=x0.device)

        def step(carry, idx):
            x, _ = carry
            return solver.step(model.rhs, params, t0 + idx * h, x)

        _, (xs, epss) = scan_save(step, (x0, torch.zeros_like(x0)), chunks * save_every, save_every)
        ts = t0 + torch.arange(chunks + 1, dtype=x0.dtype, device=x0.device) * (save_every * h)
        return {"t": ts, "x": xs, "eps": epss}

    return run


def solve(
    solver, model: ODEModel, t0, x0, num_steps: int, save_every: int = 1, params: Params = None
) -> Dict[str, torch.Tensor]:
    """One-shot convenience wrapper around :func:`make_solve_fn`; ``x0`` is a
    tensor whose dtype and device the trajectory keeps."""
    params = model.params if params is None else params
    return make_solve_fn(solver, model, num_steps, save_every)(t0, torch.as_tensor(x0), params)
