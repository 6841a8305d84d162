"""Unrolled Gauss-Jordan inverse for tiny matrices (port of
``ode_uncertainty_tpu/ops/small_inv.py``).

Pivot-free: the only caller inverts the simplified-Newton matrix
``I - h*gamma*J`` of the Kvaerno3 step (``solvers/sdirk.py``), a perturbation
of the identity that is diagonally dominant for the shipped stiff problems.
For general matrices use ``torch.linalg.inv``.
"""

from __future__ import annotations

import torch


def inv_small(a: torch.Tensor) -> torch.Tensor:
    """Inverse of ``a`` [..., n, n] by an unrolled pivot-free Gauss-Jordan
    sweep on the [..., n, 2n] augmented matrix (n rank-1 updates)."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    m = torch.cat([a, eye], dim=-1)  # [..., n, 2n]
    for j in range(n):
        pivot = m[..., j : j + 1, j : j + 1]  # [..., 1, 1]
        row = m[..., j : j + 1, :] / pivot  # [..., 1, 2n]
        col = m[..., :, j : j + 1]  # [..., n, 1]
        # one rank-1 update eliminates column j from every row (row j
        # zeroes itself), then row j is restored
        m = m - col * row
        m = torch.cat([m[..., :j, :], row, m[..., j + 1 :, :]], dim=-2)
    return m[..., :, n:]
