"""Unrolled Householder QR for small static shapes (port of
``ode_uncertainty_tpu/ops/small_qr.py``).

(m, n) are known when the sweep is built, so it unrolls into n reflector
steps of batched elementwise/reduce ops over ``[..., m, n]`` tensors. Only
the R factor is produced: the filter algebra never needs Q.
"""

from __future__ import annotations

import torch

# Shapes at or below this use the unrolled path; beyond it the library QR.
MAX_UNROLLED_DIM = 32


def eps_guard(dtype: torch.dtype) -> float:
    """Zero-column threshold ``(4 ulp)^2`` of the dtype."""
    return (4.0 * torch.finfo(dtype).eps) ** 2


def qr_r_small(a: torch.Tensor) -> torch.Tensor:
    """R factor of a thin QR for a [..., m, n] batch with m >= n.

    Returns [..., n, n] upper-triangular R with R^T R = A^T A (row signs
    unspecified, irrelevant for sqrt-covariance use).
    """
    m, n = a.shape[-2], a.shape[-1]
    if m < n:
        raise ValueError(f"qr_r_small requires m >= n, got {(m, n)}")

    # Scale-equivariant sweep: factor out the matrix magnitude so the
    # reflectors operate at O(1) (qr(c*A) = c*qr(A), so rescaling is exact).
    scale = torch.amax(torch.abs(a), dim=(-2, -1), keepdim=True)
    scale = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    # Zero-column guard at machine resolution relative to the scaled matrix:
    # a column below ~4*ulp contributes < eps^2 to the covariance sum.
    eps = eps_guard(a.dtype)

    r = a / scale
    for j in range(n):
        # Householder reflector zeroing r[..., j+1:, j] against r[..., j, j].
        col = r[..., j:, j]  # [..., m-j]
        sigma = torch.sqrt(torch.sum(col * col, dim=-1, keepdim=True))  # [..., 1]
        sign = torch.where(col[..., :1] >= 0, 1.0, -1.0).to(a.dtype)
        alpha = -sign * sigma  # R diagonal entry
        v = torch.cat([col[..., :1] + sigma * sign, col[..., 1:]], dim=-1)  # col - alpha*e1
        vnorm_sq = torch.sum(v * v, dim=-1, keepdim=True)
        # Guard zero columns: reflector becomes identity.
        inv = torch.where(
            vnorm_sq > eps, 2.0 / torch.clamp(vnorm_sq, min=eps), torch.zeros_like(vnorm_sq)
        )

        block = r[..., j:, j:]  # [..., m-j, n-j]
        coeff = torch.einsum("...i,...ik->...k", v, block) * inv  # [..., n-j]
        block = block - v[..., :, None] * coeff[..., None, :]
        # Column j is now exactly [alpha, 0, ..., 0].
        first = torch.where(vnorm_sq[..., 0] > eps, alpha[..., 0], col[..., 0])
        head = torch.cat([first[..., None], torch.zeros_like(block[..., 1:, 0])], dim=-1)
        block = torch.cat([head[..., :, None], block[..., :, 1:]], dim=-1)
        r = torch.cat([r[..., :j, :], torch.cat([r[..., j:, :j], block], dim=-1)], dim=-2)

    return r[..., :n, :] * scale


def use_unrolled(m: int, n: int) -> bool:
    return n <= MAX_UNROLLED_DIM and m <= 4 * MAX_UNROLLED_DIM
