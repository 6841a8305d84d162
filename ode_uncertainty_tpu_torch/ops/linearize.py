"""Linearization pushforward for square-root covariance propagation (port of
``ode_uncertainty_tpu/ops/linearize.py``).

The square-root EKF needs ``J @ P_sqrt`` where J is the Jacobian of a solver
step. Two routes compute it:

  * forward mode (the default): one ``torch.func.jvp`` per column of
    ``P_sqrt`` pushes that column through the step, without materializing
    J. It composes with an outer reverse pass (the NLL gradient through
    ``make_nll``) and with the Kvaerno3 stage-solve rule.
  * reverse mode (``reverse=True``): one forward pass of the step on n
    copies of the state and one backward pass give the n rows of J, then
    ``J @ P_sqrt``. Forward-mode AD dispatches every product of a tangent
    with a constant (a parameter, a tableau weight) through a Python path
    in PyTorch, about 0.25 ms an operation, so this route is about 20x
    faster for an explicit step; it is first order only (no outer
    gradient) and needs the step's reverse rule.

:func:`value_and_jacfwd` gives a dense Jacobian by the forward route and
:func:`pull_sqrt` the reverse-mode product ``M @ J`` (through the Kvaerno3
step it applies the transpose of the stage-solve rule).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def push_sqrt(f: Callable, x: torch.Tensor, p_sqrt: torch.Tensor, reverse: bool = False):
    """Evaluates y = f(x) and J_f(x) @ P_sqrt.

    Args:
        f: function taking a flat state [..., n] and returning a tuple whose
            first element is the next flat state [..., n] (aux outputs
            allowed, e.g. the local-error estimate). It acts lane by lane
            on the leading dims.
        x: [..., n] primal input.
        p_sqrt: [..., n, k] matrix whose columns are pushed through the
            linearization (typically the covariance sqrt factor, k = n).
        reverse: take the reverse-mode route (see the module note); the
            result is detached from any outer graph.

    Returns:
        (out, jp) where ``out = f(x)`` (full tuple) and ``jp`` [..., n, k] is
        the Jacobian of the first output applied to ``p_sqrt``.
    """
    if reverse:
        return _push_reverse(f, x, p_sqrt)
    x = x.contiguous()  # a dual tensor needs its own memory, not an expanded view
    cols = []
    out = None
    for c in range(p_sqrt.shape[-1]):
        tangent = p_sqrt[..., c].expand_as(x).contiguous()
        out, t_out = torch.func.jvp(f, (x,), (tangent,))
        cols.append(t_out[0])
    return out, torch.stack(cols, dim=-1)


def value_and_jacfwd(f: Callable, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (f(x) [..., m], the dense forward-mode Jacobian [..., m, n]) of
    ``f: [..., n] -> [..., m]``, acting lane by lane."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    (out,), jac = push_sqrt(lambda z: (f(z),), x, eye)
    return out, jac


def pull_sqrt(f: Callable, x: torch.Tensor, m_rows: torch.Tensor):
    """Reverse-mode alternative to :func:`push_sqrt`: ``M @ J_f`` from one
    VJP per row of M. ``f`` returns (primary [..., n], aux).

    Returns ((out, aux), mj) with mj [..., k, n] = m_rows @ J.
    """
    out, vjp_fn, aux = torch.func.vjp(f, x, has_aux=True)
    rows = [vjp_fn(m_rows[..., i, :].expand_as(out).contiguous())[0] for i in range(m_rows.shape[-2])]
    return (out, aux), torch.stack(rows, dim=-2)


def _push_reverse(f: Callable, x: torch.Tensor, p_sqrt: torch.Tensor):
    """Rows of J from one backward pass over n copies of x, stacked on a new
    leading axis (where per-lane parameters [...] still broadcast): copy i's
    output component i is seeded with 1, so the gradient on copy i is row i."""
    n = x.shape[-1]
    with torch.enable_grad():
        copies = x.detach().expand(n, *x.shape).clone().requires_grad_(True)
        out = f(copies)
        eye = torch.eye(n, dtype=x.dtype, device=x.device)
        seed = eye.reshape(n, *([1] * (x.dim() - 1)), n).expand_as(out[0])
        (rows,) = torch.autograd.grad(out[0], copies, seed)
    return tuple(o[0].detach() for o in out), rows.movedim(0, -2) @ p_sqrt
