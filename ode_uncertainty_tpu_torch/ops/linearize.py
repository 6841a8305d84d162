"""Linearization pushforward for square-root covariance propagation (port of
``ode_uncertainty_tpu/ops/linearize.py``).

The square-root EKF needs ``J @ P_sqrt`` where J is the Jacobian of a solver
step, without materializing J: one ``torch.func.jvp`` per column of
``P_sqrt`` pushes that column through the step.
"""

from __future__ import annotations

from typing import Callable

import torch


def push_sqrt(f: Callable, x: torch.Tensor, p_sqrt: torch.Tensor):
    """Evaluates y = f(x) and J_f(x) @ P_sqrt.

    Args:
        f: function taking a flat state [..., n] and returning a tuple whose
            first element is the next flat state [..., n] (aux outputs
            allowed, e.g. the local-error estimate).
        x: [..., n] primal input.
        p_sqrt: [..., n, k] matrix whose columns are pushed through the
            linearization (typically the covariance sqrt factor, k = n).

    Returns:
        (out, jp) where ``out = f(x)`` (full tuple) and ``jp`` [..., n, k] is
        the Jacobian of the first output applied to ``p_sqrt``.
    """
    x = x.contiguous()  # a dual tensor needs its own memory, not an expanded view
    cols = []
    out = None
    for c in range(p_sqrt.shape[-1]):
        tangent = p_sqrt[..., c].expand_as(x).contiguous()
        out, t_out = torch.func.jvp(f, (x,), (tangent,))
        cols.append(t_out[0])
    return out, torch.stack(cols, dim=-1)

