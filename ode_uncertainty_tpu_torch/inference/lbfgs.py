"""Box-constrained L-BFGS on the device (port of
``ode_uncertainty_tpu/inference/lbfgs.py``).

Projected L-BFGS: the quasi-Newton direction from a ring-buffer two-loop
recursion, a backtracking Armijo line search on the box-projected trial
point, curvature-guarded history updates, and the projected-gradient
infinity norm as the stopping criterion.

The reference runs one lane per ``lax.while_loop`` and batches restarts with
``vmap``. Here the lanes are a leading axis of every state tensor and the
objective is batched, ``fun(x [B, P]) -> [B]`` with lanes independent; the
gradient is autograd's of the lanes' sum. Each lane takes exactly the
reference's steps: a finished lane is frozen, and a line-search trial
evaluates only the lanes still searching (gathered, then scattered back),
so a lane's evaluation count is its own. The state stays on the objective's
device; the host reads only the loop conditions, one reduction per
iteration and one per line-search trial.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LBFGSResult(NamedTuple):
    x: torch.Tensor  # [B, P] final (projected) iterate
    f: torch.Tensor  # [B] objective at x
    g: torch.Tensor  # [B, P] gradient at x
    iters: torch.Tensor  # [B] int32 outer iterations taken
    n_fev: torch.Tensor  # [B] int32 objective evaluations (incl. line search)
    converged: torch.Tensor  # [B] bool projected-gradient tolerance reached


class _State(NamedTuple):
    x: torch.Tensor  # [B, P]
    f: torch.Tensor  # [B]
    g: torch.Tensor  # [B, P]
    s_hist: torch.Tensor  # [B, m, P]
    y_hist: torch.Tensor  # [B, m, P]
    rho: torch.Tensor  # [B, m]
    head: torch.Tensor  # [B] ring-buffer write position
    count: torch.Tensor  # [B] valid history entries (<= m)
    iters: torch.Tensor  # [B]
    n_fev: torch.Tensor  # [B]
    done: torch.Tensor  # [B] converged or stalled
    stall: torch.Tensor  # [B] consecutive accepted steps with below-slack progress


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _bounds(lower, upper, x: torch.Tensor):
    p = x.shape[-1]
    lo = torch.as_tensor(lower, dtype=x.dtype, device=x.device).broadcast_to((p,))
    hi = torch.as_tensor(upper, dtype=x.dtype, device=x.device).broadcast_to((p,))
    return lo, hi


def _pg_norm(x, g, lo, hi) -> torch.Tensor:
    """Infinity norm of the projected gradient (KKT residual), per lane."""
    return torch.amax(torch.abs(x - torch.clamp(x - g, lo, hi)), dim=-1)


def value_and_grad(fun: Callable, x: torch.Tensor):
    """``(f [B], g [B, P])``: the objective and each lane's gradient (the
    gradient of the lanes' sum: each lane's value depends on its own row)."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        f = fun(xr)
        (g,) = torch.autograd.grad(f, xr, grad_outputs=torch.ones_like(f))
    return f.detach(), g


def _two_loop(g, s_hist, y_hist, rho, head, count, m):
    """L-BFGS two-loop recursion over each lane's ring buffer with masked
    slots: g [B, P], histories [B, m, P], rho [B, m], head/count [B]."""
    lanes = torch.arange(g.shape[0], device=g.device)
    q = g
    alpha = torch.zeros_like(rho)
    for i in range(m):
        j = (head - 1 - i) % m
        s_j, y_j = s_hist[lanes, j], y_hist[lanes, j]
        a = torch.where(i < count, rho[lanes, j] * _dot(s_j, q), 0.0)
        q = q - a[:, None] * y_j
        alpha[lanes, j] = a

    j_last = (head - 1) % m
    s_l, y_l = s_hist[lanes, j_last], y_hist[lanes, j_last]
    denom = _dot(y_l, y_l)
    gamma = torch.where((count > 0) & (denom > 0.0), _dot(s_l, y_l) / denom, 1.0)
    r = gamma[:, None] * q
    for i in range(m):
        j = (head - count + i) % m
        s_j, y_j = s_hist[lanes, j], y_hist[lanes, j]
        b = rho[lanes, j] * _dot(y_j, r)
        r = r + torch.where(i < count, alpha[lanes, j] - b, 0.0)[:, None] * s_j
    return -r


def lbfgs_box_init(
    fun: Callable,
    x0: torch.Tensor,
    lower=0.0,
    upper=1.0,
    history: int = 10,
    tol: float = 1e-6,
) -> _State:
    """Builds the initial optimizer state of the lanes x0 [B, P] (one
    objective evaluation)."""
    b, p = x0.shape
    lo, hi = _bounds(lower, upper, x0)
    x0 = torch.clamp(x0, lo, hi)
    f0, g0 = value_and_grad(fun, x0)
    int_zeros = torch.zeros(b, dtype=torch.int32, device=x0.device)
    return _State(
        x=x0,
        f=f0,
        g=g0,
        s_hist=x0.new_zeros((b, history, p)),
        y_hist=x0.new_zeros((b, history, p)),
        rho=x0.new_zeros((b, history)),
        head=int_zeros,
        count=int_zeros,
        iters=int_zeros,
        n_fev=torch.ones_like(int_zeros),
        done=_pg_norm(x0, g0, lo, hi) <= tol,
        stall=int_zeros,
    )


def lbfgs_box_segment(
    fun: Callable,
    state: _State,
    iter_limit,
    lower=0.0,
    upper=1.0,
    tol: float = 1e-6,
    max_linesearch: int = 25,
    armijo_c1: float = 1e-4,
    stall_iters: int = 5,
) -> _State:
    """Runs every lane until it converges, stalls or reaches
    ``iters >= iter_limit``; returns the new state (``state`` is not
    changed). Running in segments of increasing ``iter_limit`` gives the
    values of one call.

    ``stall_iters``: a lane making less than the slack's progress for this
    many consecutive accepted steps is marked done (0 disables)."""
    x, f, g, s_hist, y_hist, rho, head, count, iters, n_fev, done, stall = (t.clone() for t in state)
    lo, hi = _bounds(lower, upper, x)
    m = s_hist.shape[1]
    eps = torch.finfo(x.dtype).eps
    one = torch.ones((), dtype=x.dtype, device=x.device)

    while True:
        act = torch.nonzero(~done & (iters < iter_limit)).squeeze(1)  # host read
        if act.numel() == 0:
            break
        xa, fa, ga = x[act], f[act], g[act]
        s_a, y_a, rho_a, head_a, count_a = s_hist[act], y_hist[act], rho[act], head[act], count[act]
        d = _two_loop(ga, s_a, y_a, rho_a, head_a, count_a, m)
        # steepest descent where the direction is not a descent direction
        d = torch.where((_dot(ga, d) < 0.0)[:, None], d, -ga)
        # sufficient-decrease slack at the dtype's resolution of f
        f_slack = 16.0 * eps * torch.maximum(torch.abs(fa), one)

        def trial(sub, alpha):
            x_t = torch.clamp(xa[sub] + alpha[:, None] * d[sub], lo, hi)
            f_t, g_t = value_and_grad(fun, x_t)
            # Armijo with the projected step (x_t - x)
            decrease = f_t <= fa[sub] + armijo_c1 * _dot(ga[sub], x_t - xa[sub]) + f_slack[sub]
            moved = torch.amax(torch.abs(x_t - xa[sub]), dim=-1) > 0.0
            return x_t, f_t, g_t, decrease & moved & torch.isfinite(f_t)

        every = torch.arange(act.numel(), device=x.device)
        alpha = torch.ones(act.numel(), dtype=x.dtype, device=x.device)
        x_t, f_t, g_t, ok = trial(every, alpha)
        tries = torch.ones_like(head_a)
        while True:
            sub = torch.nonzero(~ok & (tries < max_linesearch)).squeeze(1)  # host read
            if sub.numel() == 0:
                break
            alpha[sub] = alpha[sub] * 0.5
            x_t[sub], f_t[sub], g_t[sub], ok[sub] = trial(sub, alpha[sub])
            tries[sub] += 1

        # a failed search with history clears it (the next iteration
        # backtracks along steepest descent); one without history ends the lane
        reset = ~ok & (count_a > 0)
        s_vec, y_vec = x_t - xa, g_t - ga
        sy = _dot(s_vec, y_vec)
        good = ok & (sy > 1e-10 * torch.linalg.vector_norm(s_vec, dim=-1) * torch.linalg.vector_norm(y_vec, dim=-1))
        lanes = torch.arange(act.numel(), device=x.device)
        s_a[lanes, head_a] = torch.where(good[:, None], s_vec, s_a[lanes, head_a])
        y_a[lanes, head_a] = torch.where(good[:, None], y_vec, y_a[lanes, head_a])
        rho_a[lanes, head_a] = torch.where(good, 1.0 / sy, rho_a[lanes, head_a])
        zero = torch.zeros_like(head_a)
        head_new = torch.where(reset, zero, torch.where(good, (head_a + 1) % m, head_a))
        count_new = torch.where(reset, zero, torch.where(good, torch.clamp(count_a + 1, max=m), count_a))

        x_new = torch.where(ok[:, None], x_t, xa)
        f_new = torch.where(ok, f_t, fa)
        g_new = torch.where(ok[:, None], g_t, ga)
        progressed = (fa - f_new) > f_slack
        stall_new = torch.where(ok & ~progressed, stall[act] + 1, zero)
        done_new = (~ok & ~reset) | (_pg_norm(x_new, g_new, lo, hi) <= tol)
        if stall_iters > 0:
            done_new = done_new | (stall_new >= stall_iters)

        x[act], f[act], g[act] = x_new, f_new, g_new
        s_hist[act], y_hist[act], rho[act] = s_a, y_a, rho_a
        head[act], count[act] = head_new, count_new
        iters[act] += 1
        n_fev[act] += tries
        done[act], stall[act] = done_new, stall_new

    return _State(x, f, g, s_hist, y_hist, rho, head, count, iters, n_fev, done, stall)


def lbfgs_result(state: _State, lower=0.0, upper=1.0, tol: float = 1e-6) -> LBFGSResult:
    """Converts an optimizer state into the public result record."""
    lo, hi = _bounds(lower, upper, state.x)
    return LBFGSResult(
        x=state.x,
        f=state.f,
        g=state.g,
        iters=state.iters,
        n_fev=state.n_fev,
        converged=_pg_norm(state.x, state.g, lo, hi) <= tol,
    )


def lbfgs_box(
    fun: Callable,
    x0: torch.Tensor,
    lower=0.0,
    upper=1.0,
    max_iter: int = 200,
    history: int = 10,
    tol: float = 1e-6,
    max_linesearch: int = 25,
    armijo_c1: float = 1e-4,
) -> LBFGSResult:
    """Minimizes the batched ``fun(x [B, P]) -> [B]`` over the box [lower,
    upper] from the lanes x0 [B, P]. Non-finite trial values count as
    line-search failures (the backtracking shrinks past them), so an
    objective that is unstable at extreme parameters needs no guard."""
    state = lbfgs_box_init(fun, x0, lower, upper, history, tol)
    state = lbfgs_box_segment(
        fun, state, max_iter, lower, upper, tol=tol, max_linesearch=max_linesearch, armijo_c1=armijo_c1
    )
    return lbfgs_result(state, lower, upper, tol)
