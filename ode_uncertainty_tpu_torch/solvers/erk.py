"""Explicit embedded Runge-Kutta stepper (port of ``ode_uncertainty_tpu/solvers/erk.py``).

Stages are unrolled in Python with zero tableau entries skipped, so the step
is a plain differentiable function of ``(t, x, params)``, which is what the
square-root EKF linearizes.

Contract: ``step(rhs, params, t, x) -> (x_next, eps)`` where ``eps`` is the
embedded local-error magnitude ``|x_hat - x_next|``; ``x`` is ``[..., N, D]``.
"""

from __future__ import annotations

import dataclasses

import torch

from ode_uncertainty_tpu_torch.models.base import ODEFn, Params
from ode_uncertainty_tpu_torch.solvers import tableaus
from ode_uncertainty_tpu_torch.solvers.tableaus import ButcherTableau


def _weighted_sum(terms, weights):
    """sum_i w_i * terms_i, skipping structural zeros."""
    acc = None
    for w, k in zip(weights, terms):
        if w == 0.0:
            continue
        contrib = w * k
        acc = contrib if acc is None else acc + contrib
    return acc


@dataclasses.dataclass(frozen=True)
class ERK:
    """Explicit embedded RK solver with fixed step size ``h``."""

    tableau: ButcherTableau
    h: float = 0.1

    @property
    def name(self) -> str:
        return self.tableau.name

    def step(self, rhs: ODEFn, params: Params, t, x: torch.Tensor):
        """One fixed step: returns (x_next, eps)."""
        tab = self.tableau
        h = self.h
        ks = []
        for i in range(tab.num_stages):
            if i == 0:
                xi = x
            else:
                incr = _weighted_sum(ks, tab.a[i][:i])
                xi = x if incr is None else x + h * incr
            ks.append(rhs(t + tab.c[i] * h, xi, params))
        x_next = x + h * _weighted_sum(ks, tab.b_sol)
        # the local error is a difference of O(1) stage sums; below float64
        # it is summed in float64, so that it rounds at its own magnitude
        # (summed in the stages' precision it falls on the grid of their
        # ulp and can be exactly 0, which makes the local-error covariance
        # singular)
        wide = ks if x.dtype == torch.float64 else [k.to(torch.float64) for k in ks]
        err = _weighted_sum(wide, tuple(e - s for e, s in zip(tab.b_err, tab.b_sol)))
        eps = torch.abs(h * err).to(x.dtype)
        return x_next, eps


def heun_euler(step_size: float = 0.1) -> ERK:
    return ERK(tableaus.HEUN_EULER, step_size)


def bs32(step_size: float = 0.1) -> ERK:
    return ERK(tableaus.BS32, step_size)


def rkf45(step_size: float = 0.1) -> ERK:
    return ERK(tableaus.RKF45, step_size)


def dopri65(step_size: float = 0.1) -> ERK:
    return ERK(tableaus.DOPRI65, step_size)
