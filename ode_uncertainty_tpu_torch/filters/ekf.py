"""Dense-covariance extended Kalman filter (port of
``ode_uncertainty_tpu/filters/ekf.py``).

Full-covariance propagation through the solver-step Jacobian with a
Joseph-form correction; an extension beside the square-root filter, for
parity and cross-validation. Leading batch dims are carried through.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ode_uncertainty_tpu_torch.filters.cov_updates import DiagonalUpdate
from ode_uncertainty_tpu_torch.filters.sqrt_ekf import linearized_step
from ode_uncertainty_tpu_torch.ops.sqrt_linalg import cholesky
from ode_uncertainty_tpu_torch.ops.tri_solve import cho_solve_small


@dataclasses.dataclass(frozen=True)
class DenseEKFState:
    t: torch.Tensor  # []
    x: torch.Tensor  # [..., N, D]
    eps: torch.Tensor  # [..., N, D]
    P: torch.Tensor  # [..., n, n] full covariance
    y_hat: torch.Tensor  # [..., L]
    S: torch.Tensor  # [..., L, L]

    def replace(self, **kw) -> "DenseEKFState":
        return dataclasses.replace(self, **kw)


def dense_init_state(t0, x0: torch.Tensor, p0: torch.Tensor, obs_dim: int) -> DenseEKFState:
    dtype, device = x0.dtype, x0.device
    return DenseEKFState(
        t=torch.as_tensor(t0, dtype=dtype, device=device),
        x=x0,
        eps=torch.zeros_like(x0),
        P=p0.to(dtype),
        y_hat=torch.zeros((obs_dim,), dtype=dtype, device=device),
        S=torch.zeros((obs_dim, obs_dim), dtype=dtype, device=device),
    )


def dense_correct(state: DenseEKFState, H, y, r: torch.Tensor) -> DenseEKFState:
    """Kalman update with the full covariance (Joseph form); shared with the
    dense UKF, whose linear-measurement update is the same."""
    n = state.P.shape[-1]
    xf = state.x.reshape(*state.x.shape[:-2], n)
    y_hat = xf @ H.T
    s = H @ state.P @ H.T + r + 1e-8 * torch.eye(H.shape[0], dtype=state.P.dtype, device=state.P.device)
    k = cho_solve_small(cholesky(s), H @ state.P).transpose(-1, -2)
    x_new = xf + (k @ (y - y_hat)[..., None])[..., 0]
    a = torch.eye(n, dtype=state.P.dtype, device=state.P.device) - k @ H
    p_new = a @ state.P @ a.transpose(-1, -2) + k @ r @ k.transpose(-1, -2)  # Joseph form
    return state.replace(x=x_new.reshape(state.x.shape), P=p_new, y_hat=y_hat, S=s)


@dataclasses.dataclass(frozen=True)
class DenseEKF:
    """Full-covariance EKF."""

    cov_update: object = DiagonalUpdate()

    def init_state(self, t0, x0: torch.Tensor, p0: torch.Tensor, obs_dim: int) -> DenseEKFState:
        return dense_init_state(t0, x0, p0, obs_dim)

    def make_predict(self, solver, rhs: Callable):
        cov_update = self.cov_update

        def predict(state: DenseEKFState, params, q: torch.Tensor, gamma) -> DenseEKFState:
            shape = state.x.shape
            n = shape[-2] * shape[-1]
            # the Jacobian applied to the identity is the dense J
            eye = torch.eye(n, dtype=state.x.dtype, device=state.x.device)
            x_next_f, eps_f, jac = linearized_step(solver, rhs, params, state.t, state.x, eye)
            p_pred = jac @ state.P @ jac.transpose(-1, -2)
            p_new = cov_update.apply(p_pred, eps_f) + gamma * q
            return state.replace(
                t=state.t + solver.h,
                x=x_next_f.reshape(shape),
                eps=eps_f.reshape(shape),
                P=p_new,
            )

        return predict

    def make_correct(self):
        return dense_correct
