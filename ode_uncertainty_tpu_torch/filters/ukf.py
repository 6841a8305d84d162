"""Unscented Kalman filters, dense and square-root (port of
``ode_uncertainty_tpu/filters/ukf.py``).

An augmented unscented transform over (state ⊕ process noise) propagates
sigma points through the solver step and injects local-error noise per
sigma point, so the noise enters the transform nonlinearly. The sigma points
are one leading dimension, stepped at once.

The square-root variant keeps a triangular factor throughout: the predicted
factor comes from a QR of the weighted sigma deviations plus a rank-1
Cholesky update for the (possibly negative) center weight
(``ops/chol_update.py``).

The correction assumes the linear measurement model of every shipped
experiment (y = H x + r); the unscented transform then coincides with the
exact Kalman update, so it is computed exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ode_uncertainty_tpu_torch.filters.cov_updates import DiagonalUpdate
from ode_uncertainty_tpu_torch.filters.ekf import DenseEKFState, dense_correct, dense_init_state
from ode_uncertainty_tpu_torch.filters.sqrt_ekf import EKFState, SqrtEKF
from ode_uncertainty_tpu_torch.ops.chol_update import chol_update
from ode_uncertainty_tpu_torch.ops.sqrt_linalg import cho_solve_sqrt, cholesky, sqrt_sum, tria


def _ut_weights(n_aug: int, alpha: float, beta: float, kappa: float, dtype, device=None):
    """(w_m [K], w_c [K], n_aug + lambda) of the K = 2 n_aug + 1 sigma points."""
    lam = alpha**2 * (n_aug + kappa) - n_aug
    w_m0 = lam / (n_aug + lam)
    w_c0 = w_m0 + (1.0 - alpha**2 + beta)
    w_i = 1.0 / (2.0 * (n_aug + lam))
    # filled on the device (no host-to-device copy, so a CUDA graph can
    # capture them)
    full = lambda shape, v: torch.full(shape, v, dtype=dtype, device=device)
    wings = full((2 * n_aug,), w_i)
    return torch.cat([full((1,), w_m0), wings]), torch.cat([full((1,), w_c0), wings]), full((), n_aug + lam)


def _weighted(w: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """sum_k w_k pts[k] over the leading sigma axis, term by term in k order:
    elementwise operations, which round alike on every device (the center
    weight is about -130 for the shipped sizes, so the sum cancels and its
    rounding order shows)."""
    acc = w[0] * pts[0]
    for k in range(1, pts.shape[0]):
        acc = acc + w[k] * pts[k]
    return acc


@dataclasses.dataclass(frozen=True)
class UKF:
    """Dense augmented-state unscented Kalman filter."""

    cov_update: object = DiagonalUpdate()
    alpha: float = 0.1
    beta: float = 2.0
    kappa: float | None = None

    def init_state(self, t0, x0, p0, obs_dim: int) -> DenseEKFState:
        return dense_init_state(t0, x0, p0, obs_dim)

    def _sigma_points(self, xf, chol_aug, scale):
        """[2 n_aug + 1, ..., n_aug] augmented sigma points around (x, 0)."""
        n = xf.shape[-1]
        n_aug = chol_aug.shape[-1]
        m0 = torch.cat([xf, xf.new_zeros(*xf.shape[:-1], n_aug - n)], dim=-1)
        offs = (torch.sqrt(scale) * chol_aug.transpose(-1, -2)).movedim(-2, 0)  # rows are directions
        return torch.cat([m0[None], m0[None] + offs, m0[None] - offs], dim=0)

    def _propagate(self, solver, rhs, params, state, chol_state):
        """Shared augmented-UT propagation: returns (pts_next [K, ..., n],
        w_m, w_c, eps_center [..., n])."""
        shape = state.x.shape
        n = shape[-2] * shape[-1]
        n_aug = 2 * n
        dtype, device = state.x.dtype, state.x.device
        kappa = 3.0 - n_aug if self.kappa is None else self.kappa
        w_m, w_c, scale = _ut_weights(n_aug, self.alpha, self.beta, kappa, dtype, device)

        batch = chol_state.shape[:-2]
        chol_aug = torch.zeros((*batch, n_aug, n_aug), dtype=dtype, device=device)
        chol_aug[..., :n, :n] = chol_state
        chol_aug[..., n:, n:] = torch.eye(n, dtype=dtype, device=device)

        pts = self._sigma_points(state.x.reshape(*shape[:-2], n), chol_aug, scale)  # [K, ..., 2n]
        xs, zs = pts[..., :n], pts[..., n:]
        x_next, eps = solver.step(rhs, params, state.t, xs.reshape(*xs.shape[:-1], *shape[-2:]))
        xs_next = x_next.reshape(*xs.shape)
        eps_all = eps.reshape(*xs.shape)
        # local-error noise enters through the transform: each point is
        # displaced by its own noise sqrt applied to its noise coordinates
        zero = torch.zeros((*eps_all.shape, n), dtype=dtype, device=device)
        noise_sqrt = self.cov_update.apply_sqrt(zero, eps_all)
        xs_next = xs_next + (noise_sqrt @ zs[..., None])[..., 0]
        return xs_next, w_m, w_c, eps_all[0]

    def make_predict(self, solver, rhs: Callable):
        def predict(state: DenseEKFState, params, q, gamma) -> DenseEKFState:
            n = state.P.shape[-1]
            jitter = 1e-16 * torch.eye(n, dtype=state.P.dtype, device=state.P.device)
            chol_state = cholesky(state.P + jitter)
            xs_next, w_m, w_c, eps0 = self._propagate(solver, rhs, params, state, chol_state)
            mean = _weighted(w_m, xs_next)
            dev = xs_next - mean[None]
            p_new = _weighted(w_c, dev[..., :, None] * dev[..., None, :]) + gamma * q
            return state.replace(
                t=state.t + solver.h,
                x=mean.reshape(state.x.shape),
                eps=eps0.reshape(state.x.shape),
                P=p_new,
            )

        return predict

    def make_correct(self):
        return dense_correct


@dataclasses.dataclass(frozen=True)
class SqrtUKF(UKF):
    """Square-root augmented UKF: triangular covariance factor throughout."""

    def init_state(self, t0, x0, p0_sqrt, obs_dim: int) -> EKFState:
        return SqrtEKF().init_state(t0, x0, p0_sqrt, obs_dim)

    def make_predict(self, solver, rhs: Callable):
        def predict(state: EKFState, params, q_sqrt, gamma_sqrt) -> EKFState:
            xs_next, w_m, w_c, eps0 = self._propagate(solver, rhs, params, state, state.P_sqrt)
            mean = _weighted(w_m, xs_next)
            dev = xs_next - mean[None]
            # QR over the sqrt(w)-scaled non-center deviations (+ tempering
            # noise), then a rank-1 update for the center weight (sign of w_c0)
            wing = (torch.sqrt(w_c[1:]).reshape(-1, *([1] * (dev.dim() - 1))) * dev[1:]).movedim(0, -1)
            qg = (gamma_sqrt * q_sqrt).expand(*wing.shape[:-1], q_sqrt.shape[-1])
            p_sqrt = tria(torch.cat([wing, qg], dim=-1))
            p_sqrt = chol_update(p_sqrt, dev[0], w_c[0])
            return state.replace(
                t=state.t + solver.h,
                x=mean.reshape(state.x.shape),
                eps=eps0.reshape(state.x.shape),
                P_sqrt=p_sqrt,
            )

        return predict

    def make_correct(self, unrolled: bool = False):
        """The square-root EKF's correct (``unrolled``: as there)."""

        def correct(state: EKFState, H, y, r_sqrt) -> EKFState:
            n = state.P_sqrt.shape[-1]
            xf = state.x.reshape(*state.x.shape[:-2], n)
            p = state.P_sqrt
            y_hat = xf @ H.T
            s_sqrt = sqrt_sum(H @ p, r_sqrt)
            k = (cho_solve_sqrt(s_sqrt, H, unrolled) @ p @ p.transpose(-1, -2)).transpose(-1, -2)
            x_new = xf + (k @ (y - y_hat)[..., None])[..., 0]
            a = torch.eye(n, dtype=p.dtype, device=p.device) - k @ H
            p_new = sqrt_sum(a @ p, k @ r_sqrt)
            return state.replace(x=x_new.reshape(state.x.shape), P_sqrt=p_new, y_hat=y_hat, S_sqrt=s_sqrt)

        return correct
