"""Square-root linear algebra (port of ``ode_uncertainty_tpu/ops/sqrt_linalg.py``).

Functions take arbitrary leading batch dims, which broadcast against each
other. A "sqrt factor" L satisfies ``cov = L @ L.T``; factors produced by
:func:`sqrt_sum` are lower-triangular up to column sign (the R factor of a QR
transposed), which no downstream use depends on. The solves call the
solver library, as the JAX package's do, unless ``unrolled=True``: then a
small system (n <= 32) is solved by the substitutions of
``ops/tri_solve.py``, elementwise operations that call no solver library,
so that a CUDA graph can capture them. The filter runs and the calibration
(``inference/filter_run.py``, ``calibrate.py``), whose steps are graphed
on the GPU, ask for them, as does :func:`kl_gaussian_sqrt` (the GMM
filter's merge); the estimation's ``make_nll`` does not.
"""

from __future__ import annotations

import math

import torch

from ode_uncertainty_tpu_torch.ops.small_qr import qr_r_small, use_unrolled
from ode_uncertainty_tpu_torch.ops.tri_solve import cho_solve_small, solve_triangular_small


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


def tria(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular sqrt factor of ``a @ a.T`` for a single wide factor
    a [..., n, k]."""
    return _r_factor(a.transpose(-1, -2)).transpose(-1, -2)


def nll_gaussian_sqrt(x: torch.Tensor, mean: torch.Tensor, chol: torch.Tensor, unrolled: bool = False) -> torch.Tensor:
    """Negative log density of N(mean, chol chol^T) at x (``unrolled``: see
    the module note).

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
        if unrolled:
            z = solve_triangular_small(chol.expand(*batch, n, n), diff.expand(*batch, n))
        else:
            z = torch.linalg.solve_triangular(
                chol.expand(*batch, n, n), diff.expand(*batch, n)[..., None], upper=False
            )[..., 0]
    half_maha = 0.5 * torch.sum(z * z, dim=-1)
    log_det = torch.log(torch.abs(torch.diagonal(chol, dim1=-2, dim2=-1))).sum(-1)
    return half_maha + 0.5 * n * math.log(2.0 * math.pi) + log_det


def pdf_gaussian_sqrt(x: torch.Tensor, mean: torch.Tensor, chol: torch.Tensor) -> torch.Tensor:
    """PDF of N(mean, chol chol^T) at x (broadcasting batch dims)."""
    n = x.shape[-1]
    diff = x - mean
    batch = torch.broadcast_shapes(diff.shape[:-1], chol.shape[:-2])
    diff = diff.expand(*batch, n)
    return torch.exp(-nll_gaussian_sqrt(diff, torch.zeros_like(diff), chol.expand(*batch, n, n)))


def kl_gaussian_sqrt(
    m_p: torch.Tensor, m_q: torch.Tensor, s_p: torch.Tensor, s_q: torch.Tensor
) -> torch.Tensor:
    """KL(P || Q) for Gaussians given sqrt covariance factors.

    KL = 0.5 * (logdet Q - logdet P - n + ||S_q^{-1}(m_q - m_p)||^2
         + tr(Q^{-1} P)).
    """
    n = m_p.shape[-1]
    diff = m_q - m_p
    batch = torch.broadcast_shapes(diff.shape[:-1], s_p.shape[:-2], s_q.shape[:-2])
    diff = diff.expand(*batch, n)
    s_p_b = s_p.expand(*batch, n, n)
    s_q_b = s_q.expand(*batch, n, n)

    z = solve_triangular_small(s_q_b, diff)
    maha = torch.sum(z * z, dim=-1)
    # tr(Q^{-1} P) = || S_q^{-1} S_p ||_F^2
    w = solve_triangular_small(s_q_b, s_p_b)
    tr_qp = torch.sum(w * w, dim=(-2, -1))
    log_det_p = torch.log(torch.abs(torch.diagonal(s_p_b, dim1=-2, dim2=-1)) + 1e-8).sum(-1)
    log_det_q = torch.log(torch.abs(torch.diagonal(s_q_b, dim1=-2, dim2=-1)) + 1e-8).sum(-1)
    return 0.5 * (2.0 * (log_det_q - log_det_p) - n + maha + tr_qp)


def jeffrey_gaussian_sqrt(m_1, m_2, s_1, s_2) -> torch.Tensor:
    """Symmetric KL (Jeffrey divergence) between Gaussians."""
    return kl_gaussian_sqrt(m_1, m_2, s_1, s_2) + kl_gaussian_sqrt(m_2, m_1, s_2, s_1)


def cho_solve_sqrt(chol: torch.Tensor, b: torch.Tensor, unrolled: bool = False) -> torch.Tensor:
    """Solves (chol chol^T) x = b given a (sign-indefinite) triangular factor;
    b [..., n, k], batch dims broadcast (``unrolled``: see the module note)."""
    if chol.shape[-1] == 1:  # scalar system: a division
        return b / (chol[..., 0:1, 0:1] ** 2)
    batch = torch.broadcast_shapes(chol.shape[:-2], b.shape[:-2])
    n = chol.shape[-1]
    if unrolled:
        return cho_solve_small(chol.expand(*batch, n, n), b.expand(*batch, *b.shape[-2:]))
    return torch.cholesky_solve(b.expand(*batch, *b.shape[-2:]), chol.expand(*batch, n, n), upper=False)


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``a`` [..., n, n], NaN where ``a`` is not
    positive definite (as the JAX package's ``jnp.linalg.cholesky``); no
    host synchronization, unlike ``torch.linalg.cholesky``'s error check."""
    factor, info = torch.linalg.cholesky_ex(a)
    return torch.where((info > 0)[..., None, None], torch.full_like(factor, float("nan")), factor)


def const_diag(n: int, value, dtype=None, device=None) -> torch.Tensor:
    """Diagonal matrix with a constant value."""
    return torch.diag(torch.full((n,), value, dtype=dtype, device=device))
