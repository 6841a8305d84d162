"""ESDIRK implicit stepper, Kvaerno 3(2), with embedded error estimate (port
of ``ode_uncertainty_tpu/solvers/sdirk.py``).

Same method as the JAX package: one Jacobian at the step's base point and
one explicit inverse of ``I - h*gamma*J`` (``ops/small_inv.py``) drive a
fixed number of simplified-Newton iterations per stage; the inverse only
speeds up the iterations and carries no derivative (it is detached).

The stage solve carries the implicit-function rule of the JAX package's
``custom_jvp`` (``_make_stage_solver``): the tangent of a stage solution is
``dz = (I - h*gamma*J(z*))^-1 dG`` with ``G = known + h*gamma*f(t_i, z*, p)``
at the solution z*, not the tangent of the Newton loop. Here it is a
``torch.autograd.Function`` with both rules:

  * ``jvp``, the rule itself, which ``torch.func.jvp`` (the square-root
    EKF's linearization, ``ops/linearize.py``) applies. It is built from
    differentiable operations at z*, so autograd differentiates its output
    in reverse mode: the second order that the gradient of a linearization
    (``make_nll``'s ``push_sqrt``) needs, with z* itself differentiated by
    ``backward``, as JAX differentiates the rule;
  * ``backward``, its transpose (the first order: the VJP of a step,
    ``pull_sqrt``, and the path from z* in the second order).

The Kvaerno3 NLL-gradient kernel and its plain version (``ops/nll_kernel.py``)
apply the rule's derivative directly. ``remat_stage_inverse`` is the JAX
package's TPU residual-memory knob; it is accepted and ignored.

Tableau: Kvaerno (2004) ESDIRK 3(2), stiffly accurate.
"""

from __future__ import annotations

import dataclasses

import torch

from ode_uncertainty_tpu_torch.models.base import ODEFn, Params
from ode_uncertainty_tpu_torch.ops.small_inv import inv_small

# Kvaerno 3(2) coefficients.
_GAMMA = 0.4358665215084590
_A = (
    (0.0, 0.0, 0.0, 0.0),
    (_GAMMA, _GAMMA, 0.0, 0.0),
    (0.490563388419108, 0.073570090080892, _GAMMA, 0.0),
    (0.308809969973036, 1.490563388254106, -1.235239879727145, _GAMMA),
)
_B_SOL = _A[3]  # stiffly accurate: propagated solution = last stage row
_B_ERR = _A[2]  # embedded 2nd-order solution = 3rd stage row
_C = (0.0, 2.0 * _GAMMA, 1.0, 1.0)


def jacobian(f, z: torch.Tensor) -> torch.Tensor:
    """Jacobian [..., n, n] of ``f: [..., n] -> [..., n]`` (acting lane by
    lane) at z [..., n]: one forward-mode JVP per column, vmapped."""
    n = z.shape[-1]
    eye = torch.eye(n, dtype=z.dtype, device=z.device)
    basis = eye.reshape(n, *([1] * (z.dim() - 1)), n).expand(n, *z.shape)
    cols = torch.func.vmap(lambda v: torch.func.jvp(f, (z,), (v,))[1])(basis)
    return cols.movedim(0, -1)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m @ v[..., None])[..., 0]


class StageSolve(torch.autograd.Function):
    """z with z = known + h_gamma * f(t_i, z, p), by ``newton_iters`` fixed
    simplified-Newton iterations with ``minv = inv(I - h_gamma*J_base)``;
    tangents by the implicit-function rule at the solution."""

    @staticmethod
    def forward(f_flat, newton_iters, keys, t_i, known, z0, minv, h_gamma, *pvals):
        p = dict(zip(keys, pvals))
        z = z0
        for _ in range(newton_iters):
            r = z - known - h_gamma * f_flat(t_i, z, p)
            z = z - _matvec(minv, r)
        return z

    @staticmethod
    def setup_context(ctx, inputs, output):
        f_flat, _, keys, t_i, known, _, _, h_gamma, *pvals = inputs
        ctx.f_flat, ctx.keys = f_flat, keys
        ctx.save_for_forward(t_i, known, h_gamma, output, *pvals)
        ctx.save_for_backward(t_i, known, h_gamma, output, *pvals)

    @staticmethod
    def jvp(ctx, _f, _iters, _keys, dt_i, dknown, _dz0, _dminv, dh_gamma, *dpvals):
        """dz = (I - h_gamma*J(z*))^-1 dG, dG the tangent of
        known + h_gamma*f(t_i, z*, p) with z* held fixed. Built from
        differentiable operations at z*, so reverse mode through it (the
        gradient of a linearization) reaches z* through :meth:`backward`."""
        t_i, known, h_gamma, z, *pvals = ctx.saved_tensors
        f, keys = ctx.f_flat, ctx.keys
        primals = (t_i, known, h_gamma, *pvals)
        tangents = [torch.zeros_like(x) if dx is None else dx
                    for x, dx in zip(primals, (dt_i, dknown, dh_gamma, *dpvals))]
        _, dg = torch.func.jvp(_g_of(f, keys, z), primals, tuple(tangents))
        return _matvec(_minv_at(f, keys, t_i, z, h_gamma, pvals), dg)

    @staticmethod
    def backward(ctx, dz):
        """The transpose of :meth:`jvp`: w = (I - h_gamma*J(z*))^-T dz, pulled
        back through G = known + h_gamma*f(t_i, z*, p) at z* held fixed."""
        t_i, known, h_gamma, z, *pvals = ctx.saved_tensors
        f, keys = ctx.f_flat, ctx.keys
        minv_sol = _minv_at(f, keys, t_i, z, h_gamma, pvals)
        w = (minv_sol.transpose(-1, -2) @ dz[..., None])[..., 0]
        primals = (t_i, known, h_gamma, *pvals)
        wanted = [ctx.needs_input_grad[i] for i in (3, 4, 7, *range(8, 8 + len(pvals)))]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(need) for x, need in zip(primals, wanted)]
            g = _g_of(f, keys, z.detach())(*leaves)
            needed = [x for x in leaves if x.requires_grad]
            grads = iter(torch.autograd.grad(g, needed, w, allow_unused=True) if needed else ())
        d_t, d_known, d_hg, *d_p = [next(grads) if need else None for need in wanted]
        return None, None, None, d_t, d_known, None, None, d_hg, *d_p


def _g_of(f, keys, z):
    """G(t_i, known, h_gamma, *p) = known + h_gamma*f(t_i, z, p) at a fixed z."""

    def g(ti_, known_, hg_, *pv):
        return known_ + hg_ * f(ti_, z, dict(zip(keys, pv)))

    return g


def _minv_at(f, keys, t_i, z, h_gamma, pvals):
    """(I - h_gamma*J(z))^-1 with J the Jacobian of f(t_i, ., p) at z."""
    params = dict(zip(keys, pvals))
    n = z.shape[-1]
    eye = torch.eye(n, dtype=z.dtype, device=z.device)
    return inv_small(eye - h_gamma * jacobian(lambda zz: f(t_i, zz, params), z))


@dataclasses.dataclass(frozen=True)
class Kvaerno3:
    """ESDIRK 3(2) with fixed step size and fixed Newton iteration count.
    ``remat_stage_inverse`` is accepted and ignored (see the module note)."""

    h: float = 0.1
    newton_iters: int = 6
    remat_stage_inverse: bool = False

    @property
    def name(self) -> str:
        return "kvaerno3"

    def step(self, rhs: ODEFn, params: Params, t, x: torch.Tensor):
        """One fixed step of x [..., N, D]: returns (x_next, eps)."""
        shape = x.shape
        n = shape[-2] * shape[-1]
        h = torch.as_tensor(self.h, dtype=x.dtype, device=x.device)
        h_gamma = h * _GAMMA
        eye = torch.eye(n, dtype=x.dtype, device=x.device)

        def f_flat(ti, z, p):
            return rhs(ti, z.reshape(*z.shape[:-1], *shape[-2:]), p).reshape(*z.shape[:-1], n)

        x0 = x.reshape(*shape[:-2], n)
        # simplified Newton: one Jacobian and one inverse at the base point,
        # an iteration accelerant only (no derivative flows through it, so it
        # is taken at the detached state)
        jac0 = jacobian(lambda z: f_flat(t, z, params), x0.detach())
        minv0 = inv_small(eye - h_gamma * jac0).detach()

        keys = tuple(params)
        pvals = tuple(torch.as_tensor(params[k]) for k in keys)
        ks = [f_flat(t, x0, params)]  # stage 1 is explicit (a11 = 0)
        for i in range(1, 4):
            t_i = t + _C[i] * h
            known = x0
            for j in range(i):
                if _A[i][j] != 0.0:
                    known = known + (h * _A[i][j]) * ks[j]
            z0 = known + h_gamma * ks[i - 1]
            z = StageSolve.apply(f_flat, self.newton_iters, keys, t_i, known, z0, minv0, h_gamma, *pvals)
            ks.append(f_flat(t_i, z, params))

        x_next = x0
        err = torch.zeros_like(x0)
        for i in range(4):
            if _B_SOL[i] != 0.0:
                x_next = x_next + (h * _B_SOL[i]) * ks[i]
            d = _B_ERR[i] - _B_SOL[i]
            if d != 0.0:
                err = err + (h * d) * ks[i]
        return x_next.reshape(shape), torch.abs(err).reshape(shape)


def kvaerno3(step_size: float = 0.1, newton_iters: int = 6, remat_stage_inverse: bool = False) -> Kvaerno3:
    return Kvaerno3(step_size, newton_iters, remat_stage_inverse)
