"""Square-root linear algebra (port of ``ode_uncertainty_tpu/ops/sqrt_linalg.py``).

Functions take arbitrary leading batch dims, which broadcast against each
other. A "sqrt factor" L satisfies ``cov = L @ L.T``; factors produced by
:func:`sqrt_sum` are lower-triangular up to column sign (the R factor of a QR
transposed), which no downstream use depends on.
"""

from __future__ import annotations

import math

import torch

from ode_uncertainty_tpu_torch.ops.small_qr import qr_r_small, use_unrolled


def _r_factor(stacked: torch.Tensor) -> torch.Tensor:
    """R of a thin QR; unrolled Householder for small shapes, library QR otherwise."""
    m, n = stacked.shape[-2], stacked.shape[-1]
    if use_unrolled(m, n):
        return qr_r_small(stacked)
    return torch.linalg.qr(stacked, mode="r")[1]


def sqrt_sum(*factors: torch.Tensor) -> torch.Tensor:
    """Lower-triangular L with L L^T = sum_i F_i F_i^T, via one economy QR.

    Args:
        *factors: two or more tensors [..., n, k_i]; their batch dims broadcast.

    Returns:
        [..., n, n] sqrt factor (lower-triangular up to column signs).
    """
    batch = torch.broadcast_shapes(*[f.shape[:-2] for f in factors])
    stacked = torch.cat(
        [f.transpose(-1, -2).expand(*batch, f.shape[-1], f.shape[-2]) for f in factors], dim=-2
    )
    return _r_factor(stacked).transpose(-1, -2)


def nll_gaussian_sqrt(x: torch.Tensor, mean: torch.Tensor, chol: torch.Tensor) -> torch.Tensor:
    """Negative log density of N(mean, chol chol^T) at x.

    Args:
        x: [..., n]. mean: [..., n]. chol: [..., n, n] sqrt factor (triangular
            up to column signs; only |diag| enters the log-determinant).

    Returns:
        [...] negative log likelihood.
    """
    n = x.shape[-1]
    if n == 1:  # scalar observation: a division, no triangular solve
        z = (x - mean) / chol[..., 0, 0:1]
    else:
        diff = x - mean
        batch = torch.broadcast_shapes(diff.shape[:-1], chol.shape[:-2])
        z = torch.linalg.solve_triangular(
            chol.expand(*batch, n, n), diff.expand(*batch, n)[..., None], upper=False
        )[..., 0]
    half_maha = 0.5 * torch.sum(z * z, dim=-1)
    log_det = torch.log(torch.abs(torch.diagonal(chol, dim1=-2, dim2=-1))).sum(-1)
    return half_maha + 0.5 * n * math.log(2.0 * math.pi) + log_det


def cho_solve_sqrt(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solves (chol chol^T) x = b given a (sign-indefinite) triangular factor;
    b [..., n, k], batch dims broadcast."""
    if chol.shape[-1] == 1:  # scalar system: a division
        return b / (chol[..., 0:1, 0:1] ** 2)
    batch = torch.broadcast_shapes(chol.shape[:-2], b.shape[:-2])
    n = chol.shape[-1]
    return torch.cholesky_solve(b.expand(*batch, *b.shape[-2:]), chol.expand(*batch, n, n), upper=False)


def const_diag(n: int, value, dtype=None, device=None) -> torch.Tensor:
    """Diagonal matrix with a constant value."""
    return torch.diag(torch.full((n,), value, dtype=dtype, device=device))
