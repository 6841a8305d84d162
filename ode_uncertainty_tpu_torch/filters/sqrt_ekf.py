"""Square-root extended Kalman filter over a one-step ODE solver (port of
``ode_uncertainty_tpu/filters/sqrt_ekf.py``).

Same algorithm: JVP pushforward of the covariance sqrt through the solver
step, QR-sum process-noise injection, Joseph-form sqrt correction. The state
carries explicit leading batch dims where the JAX package used ``vmap``. The
two guards of the JAX package are kept as elementwise selects:

  * predict skips the QR sum with gamma*Q when the *effective* noise is below
    ``_Q_ACTIVE_THRESHOLD`` (at gamma == 0 exactly);
  * correct uses a zero gain when the innovation sqrt is all zero.

The linearization runs in forward mode (``ops/linearize.py``) while autograd
records, so that an outer gradient (``make_nll`` under ``optimize``) flows
through it; without autograd (``torch.no_grad()``, as the trajectory and
calibration entry points run) an explicit step is linearized in reverse
mode, about 20x faster in PyTorch's eager mode. The values agree to
rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ode_uncertainty_tpu_torch.filters.cov_updates import DiagonalUpdate, StaticDiagonalUpdate
from ode_uncertainty_tpu_torch.ops.linearize import push_sqrt
from ode_uncertainty_tpu_torch.ops.sqrt_linalg import cho_solve_sqrt, sqrt_sum
from ode_uncertainty_tpu_torch.solvers.erk import ERK

_Q_ACTIVE_THRESHOLD = 1e-16


@dataclasses.dataclass(frozen=True)
class EKFState:
    """Per-chain filter state (n = N * D flat state size, L = obs dim), with
    any leading batch dims."""

    t: torch.Tensor  # []
    x: torch.Tensor  # [..., N, D] mean
    eps: torch.Tensor  # [..., N, D] last local-error estimate
    P_sqrt: torch.Tensor  # [..., n, n] covariance sqrt factor
    y_hat: torch.Tensor  # [..., L] last predicted observation
    S_sqrt: torch.Tensor  # [..., L, L] last innovation covariance sqrt

    def replace(self, **kw) -> "EKFState":
        return dataclasses.replace(self, **kw)


def linearized_step(solver, rhs: Callable, params, t, x: torch.Tensor, p_sqrt: torch.Tensor):
    """One solver step of x [..., N, D] and the push of p_sqrt [..., n, k]
    through its Jacobian: ``(x_next_flat [..., n], eps_flat [..., n], J @
    p_sqrt)``. Reverse mode for an explicit step without autograd recording,
    else forward mode (see the module note)."""
    state_shape = x.shape[-2:]
    n = state_shape[0] * state_shape[1]

    def step_flat(xf):
        lead = xf.shape[:-1]
        x_next, eps = solver.step(rhs, params, t, xf.reshape(*lead, *state_shape))
        return x_next.reshape(*lead, n), eps.reshape(*lead, n)

    reverse = isinstance(solver, ERK) and not torch.is_grad_enabled()
    (x_next_f, eps_f), jp = push_sqrt(step_flat, x.reshape(*x.shape[:-2], n), p_sqrt, reverse=reverse)
    return x_next_f, eps_f, jp


@dataclasses.dataclass(frozen=True)
class SqrtEKF:
    """Square-root EKF configuration.

    Attributes:
        cov_update: local-error covariance update (used when process noise Q
            is inactive and local-error updates are enabled).
        disable_cov_update: if True, the local-error term is not injected
            (tempering-only process noise).
    """

    cov_update: object = DiagonalUpdate()
    disable_cov_update: bool = False

    def init_state(self, t0, x0: torch.Tensor, p0_sqrt: torch.Tensor, obs_dim: int) -> EKFState:
        dtype, device = x0.dtype, x0.device
        return EKFState(
            t=torch.as_tensor(t0, dtype=dtype, device=device),
            x=x0,
            eps=torch.zeros_like(x0),
            P_sqrt=p0_sqrt.to(dtype),
            y_hat=torch.zeros((obs_dim,), dtype=dtype, device=device),
            S_sqrt=torch.zeros((obs_dim, obs_dim), dtype=dtype, device=device),
        )

    def make_predict(self, solver, rhs: Callable):
        """Returns ``predict(state, params, q_sqrt, gamma_sqrt) -> EKFState``.

        q_sqrt: [n, n] tempering process-noise sqrt; gamma_sqrt: [] tempering
        scale. Both are shared across the batch.
        """
        disable = self.disable_cov_update
        cov_update = self.cov_update

        def predict(state: EKFState, params, q_sqrt, gamma_sqrt) -> EKFState:
            shape = state.x.shape
            x_next_f, eps_f, p_pred = linearized_step(solver, rhs, params, state.t, state.x, state.P_sqrt)

            # Guard on the effective noise gamma*Q, not Q alone: at the final
            # tempering stage gamma == 0 and the QR sum is skipped. Lane by
            # lane where Q has one per lane (parameter_sensitivity).
            qg = gamma_sqrt * q_sqrt
            q_active = torch.any(torch.abs(qg) >= _Q_ACTIVE_THRESHOLD, dim=(-2, -1), keepdim=True)
            if disable:
                p_new = torch.where(q_active, sqrt_sum(p_pred, qg), p_pred)
            else:
                p_new = torch.where(
                    q_active,
                    sqrt_sum(qg, torch.diag_embed(eps_f), p_pred),
                    cov_update.apply_sqrt(p_pred, eps_f),
                )

            return state.replace(
                t=state.t + solver.h,
                x=x_next_f.reshape(shape),
                eps=eps_f.reshape(shape),
                P_sqrt=p_new,
            )

        return predict

    def make_predict_static(self, solver, rhs: Callable):
        """Conrad-baseline predict: fixed sigma^2 * I process noise per step.

        Returns ``predict(state, params, sigma) -> EKFState``; ``sigma`` is []
        or one noise level per lane of the state's leading dims (a
        calibration sweep is one batch).
        """
        static = StaticDiagonalUpdate()

        def predict(state: EKFState, params, sigma) -> EKFState:
            shape = state.x.shape
            x_next_f, eps_f, p_pred = linearized_step(solver, rhs, params, state.t, state.x, state.P_sqrt)
            return state.replace(
                t=state.t + solver.h,
                x=x_next_f.reshape(shape),
                eps=eps_f.reshape(shape),
                P_sqrt=static.apply_sqrt(sigma, p_pred, eps_f),
            )

        return predict

    def make_correct(self, unrolled: bool = False):
        """Returns ``correct(state, H, y, R_sqrt) -> EKFState`` (Joseph form);
        ``unrolled`` solves by substitution (``ops/sqrt_linalg.py``)."""

        def correct(state: EKFState, H: torch.Tensor, y: torch.Tensor, r_sqrt: torch.Tensor) -> EKFState:
            n = state.P_sqrt.shape[-1]
            batch = state.x.shape[:-2]
            xf = state.x.reshape(*batch, n)
            p = state.P_sqrt

            y_hat = xf @ H.T
            s_sqrt = sqrt_sum(H @ p, r_sqrt)

            # K = P H^T S^{-1}  computed as (S^{-1} H P P^T)^T.
            gain = (cho_solve_sqrt(s_sqrt, H, unrolled) @ p @ p.transpose(-1, -2)).transpose(-1, -2)
            s_zero = torch.all(torch.abs(s_sqrt) < _Q_ACTIVE_THRESHOLD, dim=-1).all(dim=-1)
            k = torch.where(s_zero[..., None, None], torch.zeros_like(gain), gain)

            x_new = xf + (k @ (y - y_hat)[..., None])[..., 0]
            a = torch.eye(n, dtype=p.dtype, device=p.device) - k @ H
            p_new = sqrt_sum(a @ p, k @ r_sqrt)

            return state.replace(
                x=x_new.reshape(state.x.shape),
                P_sqrt=p_new,
                y_hat=y_hat,
                S_sqrt=s_sqrt,
            )

        return correct
