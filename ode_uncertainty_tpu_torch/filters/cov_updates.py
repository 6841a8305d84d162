"""Process-noise covariance update functions (port of
``ode_uncertainty_tpu/filters/cov_updates.py``).

These inject the solver's local-error estimate ``eps`` [..., n] into the
filter covariance, in full-covariance form (``apply(cov, eps)``) and in
square-root form via a QR sum (``apply_sqrt(chol, eps)``). The samplers and
the static baseline update serve the particle filter and the calibration
sweep, which are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ode_uncertainty_tpu_torch.ops.sqrt_linalg import sqrt_sum


@dataclasses.dataclass(frozen=True)
class DiagonalUpdate:
    """cov + diag((scale * eps)^2)."""

    scale: float = 1.0

    def apply(self, cov: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return cov + torch.diag_embed((self.scale * eps) ** 2)

    def apply_sqrt(self, chol: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return sqrt_sum(chol, torch.diag_embed(self.scale * eps))


@dataclasses.dataclass(frozen=True)
class OuterUpdate:
    """cov + (scale * eps)(scale * eps)^T  (rank-1)."""

    scale: float = 1.0

    def apply(self, cov: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        v = self.scale * eps
        return cov + v[..., :, None] * v[..., None, :]

    def apply_sqrt(self, chol: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        v = self.scale * eps
        # vv^T has sqrt factor (v v^T)/||v||; guard eps = 0 (factor 0 there).
        norm2 = torch.sum(v * v, dim=-1)[..., None, None]
        safe = torch.where(norm2 > 0.0, norm2, torch.ones_like(norm2))
        outer = v[..., :, None] * v[..., None, :]
        factor = torch.where(norm2 > 0.0, outer / torch.sqrt(safe), torch.zeros_like(outer))
        return sqrt_sum(chol, factor)


COV_UPDATE_REGISTRY = {
    "DiagonalCovarianceUpdate": DiagonalUpdate,
    "OuterCovarianceUpdate": OuterUpdate,
}
