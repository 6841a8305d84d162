"""Particle (perturbation) filter — Conrad-style stochastic ODE solutions
(port of ``ode_uncertainty_tpu/filters/particle.py``).

Each step advances M particles through the solver and perturbs them with
zero-mean noise whose covariance is the local-error covariance update
evaluated at that particle's ``eps``; particle 0 stays noise-free as the
deterministic reference trajectory. There is no correction or resampling
step.

The particles are one leading dimension of the state, stepped at once. The
noise comes from a ``torch.Generator`` passed next to the state (the JAX
package keeps a PRNG key in it); every step draws from it, so it advances
every step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ode_uncertainty_tpu_torch.filters.cov_updates import DiagonalUpdate


@dataclasses.dataclass(frozen=True)
class PFState:
    """Particle ensemble state."""

    t: torch.Tensor  # []
    x: torch.Tensor  # [M, N, D]
    eps: torch.Tensor  # [M, N, D]

    def replace(self, **kw) -> "PFState":
        return dataclasses.replace(self, **kw)


def _without_particle_0(noise: torch.Tensor) -> torch.Tensor:
    noise[0] = 0.0
    return noise


@dataclasses.dataclass(frozen=True)
class ParticleFilter:
    """Prediction-only perturbation sampler."""

    cov_update: object = DiagonalUpdate()
    num_particles: int = 100

    def init_state(self, t0, x0: torch.Tensor) -> PFState:
        m = self.num_particles
        return PFState(
            t=torch.as_tensor(t0, dtype=x0.dtype, device=x0.device),
            x=x0.expand(m, *x0.shape).clone(),
            eps=torch.zeros((m, *x0.shape), dtype=x0.dtype, device=x0.device),
        )

    def make_predict(self, solver, rhs: Callable):
        """Returns ``predict(state, params, generator) -> PFState``."""
        cov_update = self.cov_update

        def predict(state: PFState, params, generator: torch.Generator) -> PFState:
            x_next, eps = solver.step(rhs, params, state.t, state.x)
            flat_eps = eps.reshape(eps.shape[0], -1)
            noise = cov_update.sample(generator, flat_eps).reshape(eps.shape)
            return state.replace(t=state.t + solver.h, x=x_next + _without_particle_0(noise), eps=eps)

        return predict

    def make_predict_static(self, solver, rhs: Callable, static_update):
        """Conrad-baseline variant: fixed-sigma perturbations.

        Returns ``predict(state, params, sigma, generator) -> PFState``.
        """

        def predict(state: PFState, params, sigma, generator: torch.Generator) -> PFState:
            x_next, eps = solver.step(rhs, params, state.t, state.x)
            flat_eps = eps.reshape(eps.shape[0], -1)
            noise = static_update.sample(sigma, generator, flat_eps).reshape(eps.shape)
            return state.replace(t=state.t + solver.h, x=x_next + _without_particle_0(noise), eps=eps)

        return predict
