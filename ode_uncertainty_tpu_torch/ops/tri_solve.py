"""Unrolled triangular solves for small sizes (port of
``ode_uncertainty_tpu/ops/tri_solve.py``): forward/backward substitution
unrolls into n multiply-adds over the batch; beyond ``MAX_UNROLLED_DIM`` the
library solve takes over."""

from __future__ import annotations

import torch

MAX_UNROLLED_DIM = 32


def solve_lower_unrolled(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solves L x = b with L [..., n, n] lower-triangular, b [..., n] or
    [..., n, k]; unrolled forward substitution."""
    n = chol.shape[-1]
    vec = b.ndim == chol.ndim - 1
    rhs = b[..., None] if vec else b  # [..., n, k]
    xs = []
    for i in range(n):
        acc = rhs[..., i, :]
        for j in range(i):
            acc = acc - chol[..., i, j, None] * xs[j]
        xs.append(acc / chol[..., i, i, None])
    x = torch.stack(xs, dim=-2)
    return x[..., 0] if vec else x


def solve_upper_unrolled(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solves U x = b with U [..., n, n] upper-triangular (back substitution)."""
    n = u.shape[-1]
    vec = b.ndim == u.ndim - 1
    rhs = b[..., None] if vec else b
    xs = [None] * n
    for i in reversed(range(n)):
        acc = rhs[..., i, :]
        for j in range(i + 1, n):
            acc = acc - u[..., i, j, None] * xs[j]
        xs[i] = acc / u[..., i, i, None]
    x = torch.stack(xs, dim=-2)
    return x[..., 0] if vec else x


def solve_triangular_small(chol: torch.Tensor, b: torch.Tensor, lower: bool = True) -> torch.Tensor:
    n = chol.shape[-1]
    if n > MAX_UNROLLED_DIM:
        vec = b.ndim == chol.ndim - 1
        x = torch.linalg.solve_triangular(chol, b[..., None] if vec else b, upper=not lower)
        return x[..., 0] if vec else x
    return solve_lower_unrolled(chol, b) if lower else solve_upper_unrolled(chol, b)


def cho_solve_small(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solves (L L^T) x = b given a triangular factor (sign-indefinite
    diagonals allowed: (LD)(LD)^T = L L^T)."""
    n = chol.shape[-1]
    if n > MAX_UNROLLED_DIM:
        vec = b.ndim == chol.ndim - 1
        x = torch.cholesky_solve(b[..., None] if vec else b, chol, upper=False)
        return x[..., 0] if vec else x
    y = solve_lower_unrolled(chol, b)
    return solve_upper_unrolled(chol.transpose(-1, -2), y)
