"""Rank-1 Cholesky update / downdate (port of
``ode_uncertainty_tpu/ops/chol_update.py``).

Computes the Cholesky factor of ``L L^T + sign * v v^T`` without refactoring,
for the square-root UKF (negative center sigma weight) and the GMM-EKF split
(covariance downdate along the split direction). The hyperbolic-rotation
sweep is unrolled over the (small) size, so it runs elementwise over any
leading batch dims.
"""

from __future__ import annotations

import torch


def _nonzero(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a == 0, torch.ones_like(a), a)


def chol_update(chol: torch.Tensor, v: torch.Tensor, multiplier=1.0) -> torch.Tensor:
    """Cholesky factor of ``chol @ chol.T + multiplier * outer(v, v)``.

    Args:
        chol: [..., n, n] lower-triangular factor.
        v: [..., n] update vector.
        multiplier: scalar or [...] tensor (positive: update, negative:
            downdate). A downdate that would make the matrix indefinite
            produces NaNs.

    Returns:
        [..., n, n] updated lower-triangular factor.
    """
    n = chol.shape[-1]
    mult = torch.as_tensor(multiplier, dtype=chol.dtype, device=chol.device)
    w = v * torch.sqrt(torch.abs(mult))[..., None]
    sign = torch.sign(mult)
    rows_below = torch.arange(n, device=chol.device)

    out_cols = []
    b = torch.ones(chol.shape[:-2], dtype=chol.dtype, device=chol.device)
    for j in range(n):
        col = chol[..., :, j]
        ljj = col[..., j]
        wj = w[..., j]
        d = ljj**2 + sign * (wj**2) / b
        d = torch.where(d > 0, d, torch.full_like(d, float("nan")))  # indefinite downdate -> NaN
        new_ljj = torch.sqrt(d)
        gamma = ljj**2 * b + sign * wj**2

        # update the trailing part of w
        w = w - (wj / _nonzero(ljj))[..., None] * col
        scale = (new_ljj / _nonzero(ljj))[..., None]
        corr = (new_ljj * wj / _nonzero(gamma))[..., None]
        new_col = scale * col + sign[..., None] * corr * w
        # zero the strictly-upper part of the column (rows < j), diagonal new_ljj
        new_col = torch.where(rows_below >= j, new_col, torch.zeros_like(new_col))
        new_col = torch.where(rows_below == j, new_ljj[..., None], new_col)
        out_cols.append(new_col)
        b = b + sign * wj**2 / _nonzero(ljj) ** 2

    return torch.stack(out_cols, dim=-1)
