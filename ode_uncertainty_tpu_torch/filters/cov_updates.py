"""Process-noise covariance update functions (port of
``ode_uncertainty_tpu/filters/cov_updates.py``).

These inject the solver's local-error estimate ``eps`` [..., n] into the
filter covariance. Each update provides:

  * ``apply(cov, eps)``             — full-covariance form,
  * ``apply_sqrt(chol, eps)``       — square-root form via a QR sum,
  * ``sample(generator, eps)``      — a draw from N(0, apply(0, eps)) for
    every lane of the leading dims, from a ``torch.Generator`` on eps's
    device (the JAX package threads a PRNG key; the two never give the same
    draws).

``sample`` uses the structure of each update (diagonal / rank 1) for an
exact O(n) draw. :class:`StaticDiagonalUpdate` (the Conrad-style fixed-noise
baseline) takes the noise level ``sigma`` as its first argument.
"""

from __future__ import annotations

import dataclasses

import torch

from ode_uncertainty_tpu_torch.ops.sqrt_linalg import sqrt_sum


def _normal(generator: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class DiagonalUpdate:
    """cov + diag((scale * eps)^2)."""

    scale: float = 1.0

    def apply(self, cov: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return cov + torch.diag_embed((self.scale * eps) ** 2)

    def apply_sqrt(self, chol: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return sqrt_sum(chol, torch.diag_embed(self.scale * eps))

    def sample(self, generator: torch.Generator, eps: torch.Tensor) -> torch.Tensor:
        return self.scale * eps * _normal(generator, eps.shape, eps)


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

    def sample(self, generator: torch.Generator, eps: torch.Tensor) -> torch.Tensor:
        # exact rank-1 draw: z * v with one scalar z ~ N(0, 1) per lane
        z = _normal(generator, eps.shape[:-1], eps)
        return (self.scale * eps) * z[..., None]


@dataclasses.dataclass(frozen=True)
class StaticDiagonalUpdate:
    """cov + sigma^2 * I — the Conrad-style fixed-noise baseline. ``sigma``
    is an argument ([] or one value per lane), so one sweep serves many
    noise levels."""

    scale: float = 1.0

    def apply(self, sigma, cov: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        del eps
        n = cov.shape[-1]
        return cov + _lane(sigma, 2) ** 2 * torch.eye(n, dtype=cov.dtype, device=cov.device)

    def apply_sqrt(self, sigma, chol: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        del eps
        n = chol.shape[-1]
        return sqrt_sum(chol, _lane(sigma, 2) * torch.eye(n, dtype=chol.dtype, device=chol.device))

    def sample(self, sigma, generator: torch.Generator, eps: torch.Tensor) -> torch.Tensor:
        return _lane(sigma, 1) * _normal(generator, eps.shape, eps)


def _lane(sigma, trailing: int):
    """``sigma`` with ``trailing`` unit axes appended when it has lanes (a
    Python number becomes a zero-dim float64 tensor, which takes the other
    operand's type)."""
    if not isinstance(sigma, torch.Tensor):
        sigma = torch.as_tensor(sigma, dtype=torch.float64)
    return sigma if sigma.ndim == 0 else sigma[(...,) + (None,) * trailing]


COV_UPDATE_REGISTRY = {
    "DiagonalCovarianceUpdate": DiagonalUpdate,
    "OuterCovarianceUpdate": OuterUpdate,
    "StaticDiagonalCovarianceUpdate": StaticDiagonalUpdate,
}
