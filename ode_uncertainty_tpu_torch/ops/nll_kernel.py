"""NLL of the square-root EKF on a uniform grid and its gradient: the CUDA
kernels and their plain PyTorch versions.

Port of ``ode_uncertainty_tpu/ops/pallas_ekf.py``. The TPU kernel
``fwd_kernel`` becomes ``csrc/nll_fwd.cu`` and ``bwd_kernel`` becomes
``csrc/nll_bwd.cu`` (one thread per lane, or per lane and parameter
direction, for the explicit steps on the tile models; the Kvaerno3
instantiations and Hodgkin-Huxley's explicit ones run a team of threads per
lane, ``csrc/team_chain.cuh``; built by ``utils/cuda_build.py``). The tile math they run
(``_build_chain_math`` and ``make_nll_tiles``) becomes :class:`ChainMath` and
:func:`nll_plain`, which evaluate the same arithmetic on lists of ``[B]``
tensors; :func:`nll_grad_plain` differentiates it with autograd. The tests
hold the plain versions against the JAX package, and ``chip_smoke.py`` holds
the kernels against the plain versions on the card.

:func:`make_nll_cuda` returns the wrapper ``nll_b(p_norm_b [B, P_opt],
gamma_sqrt) -> [B]``, differentiable through :class:`NllKernelFunction` (the
counterpart of ``_nll_phys``'s ``custom_vjp``, pallas_ekf.py:944-966): its
forward launches ``nll_fwd`` and its backward launches ``nll_bwd`` with the
incoming cotangent. For CUDA tensors each launches its kernel (or raises);
for CPU tensors each runs its plain version. Each launch adds one to
``launches[name]``. No padding is needed (the JAX wrapper pads the batch to
whole (8, 128) tiles, pallas_ekf.py:968-979): the kernels mask the ragged
last block.

Scope (:func:`supports`): the exact ``SqrtEKF`` type with
``disable_cov_update=True``, a uniform observation grid read in row order,
and a (model, solver) pair and (state, observation) size the kernels are
instantiated for (``_KERNELS``, ``_SIZES``): every explicit tableau
(Heun-Euler, Bogacki-Shampine 3(2), RKF45, Dormand-Prince 6(5)) and
Kvaerno3 on Lotka-Volterra, Lorenz, van der Pol, the pendulum, logistic
and exponential growth, at every L in 1..n; the same five steps on the
three single-compartment Hodgkin-Huxley variants, n = 4, 7 or 8, at
L = 1; each with both kernels; :meth:`NllGrad.launch` raises for the
others. Each launch also counts in ``launches_by_chain`` under its
instantiation. The gradient of the implicit step follows the stage
solve's implicit-function rule, not the Newton loop
(``ChainMath._kvaerno3_step``).

Time: by default step i of observation interval j starts at
``t_start(j) + i h``, ``t_start`` computed from the step index in double
precision and rounded to the working type once (the rule of
``make_nll_tiles``). With ``accumulate_time`` the step times are the
running sum ``t += h`` in the working type, as the JAX package's XLA
``make_nll`` (and the port's ``make_nll``) computes them; at the stimulus
edges of Hodgkin-Huxley the two rules can take different sides of
``t >= 10`` and ``t <= 90``. The entry points (``batched_nll`` in
``run_parameter_estimation.py``) run the running sum, so that ``evaluate``
and ``optimize`` compute what the JAX CLI computes in each working type.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ode_uncertainty_tpu_torch.filters.sqrt_ekf import SqrtEKF
from ode_uncertainty_tpu_torch.ops.small_inv import inv_small
from ode_uncertainty_tpu_torch.solvers import sdirk
from ode_uncertainty_tpu_torch.solvers.erk import ERK
from ode_uncertainty_tpu_torch.solvers.sdirk import Kvaerno3
from ode_uncertainty_tpu_torch.utils.cuda_build import load_library

# the models package re-exports a factory of the same name as the module
hh = importlib.import_module("ode_uncertainty_tpu_torch.models.hodgkin_huxley")

# Launches of each CUDA kernel in this process (compare runs by resetting).
# Launches come from several threads (autograd's device threads run the
# gradient kernel; the sharded estimator runs a thread per shard): the lock
# keeps every increment.
launches: Dict[str, int] = {"nll_fwd": 0, "nll_bwd": 0}
# the same launches by instantiation: (kernel, model, solver, n, L, dtype name)
launches_by_chain: Dict[tuple, int] = {}
_launches_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        for k in launches:
            launches[k] = 0
        launches_by_chain.clear()


def count_launch(name: str, cm: Optional["ChainMath"] = None) -> None:
    with _launches_lock:
        launches[name] += 1
        if cm is not None:
            key = chain_key(name, cm)
            launches_by_chain[key] = launches_by_chain.get(key, 0) + 1


def chain_key(name: str, cm: "ChainMath") -> tuple:
    """The instantiation a launch of kernel ``name`` on chain ``cm`` runs."""
    return (name, cm.model_name, cm.solver.name, cm.n, cm.L, str(cm.dtype).removeprefix("torch."))


# --------------------------------------------------------------------------
# Per-model right-hand sides ``rhs(t, y, p)`` on lists of [B] tensors, with
# their JVPs ``rhs_jvp(t, y, dy, p)`` and Jacobians, written in the
# evaluation order of the JAX tile RHS (pallas_ekf.py:71-151) and of the
# model functors in csrc/ekf_chain.cuh. ``t`` is a zero-dim tensor.
# --------------------------------------------------------------------------

def _rhs_lotka_volterra(t, y, p):
    prey, pred = y
    return [
        p["alpha"] * prey - p["beta"] * prey * pred,
        p["delta"] * prey * pred - p["gamma"] * pred,
    ]


def _rhs_jvp_lotka_volterra(t, y, dy, p):
    prey, pred = y
    dprey, dpred = dy
    return [
        p["alpha"] * dprey - (p["beta"] * dprey * pred + p["beta"] * prey * dpred),
        (p["delta"] * dprey * pred + p["delta"] * prey * dpred) - p["gamma"] * dpred,
    ]


def _make_rhs_hodgkin_huxley(variant: str):
    """Single-compartment HH on lists of tiles: the model module's channel
    derivatives on the stacked state (the JAX tiles reuse its rate laws
    the same way, pallas_ekf.py:108-151)."""

    def rhs(t, y, p):
        return list(hh._channel_derivs(t, torch.stack(y, -1), p, variant).unbind(-1))

    return rhs


def _generic_jvp(rhs):
    """``rhs_jvp`` by forward-mode autodiff of ``rhs``."""

    def rhs_jvp(t, y, dy, p):
        return list(torch.func.jvp(lambda *yy: tuple(rhs(t, list(yy), p)), tuple(y), tuple(dy))[1])

    return rhs_jvp


def _rhs_lorenz(t, y, p):
    a, b, c = y
    return [p["sigma"] * (b - a), a * (p["rho"] - c) - b, a * b - p["beta"] * c]


def _rhs_jvp_lorenz(t, y, dy, p):
    a, b, c = y
    da, db, dc = dy
    return [
        p["sigma"] * (db - da),
        (da * (p["rho"] - c) + a * -dc) - db,
        (da * b + a * db) - p["beta"] * dc,
    ]


def _rhs_van_der_pol(t, y, p):
    pos, vel = y
    return [vel, p["damping"] * (1.0 - pos * pos) * vel - pos]


def _rhs_jvp_van_der_pol(t, y, dy, p):
    pos, vel = y
    dpos, dvel = dy
    w = p["damping"] * (1.0 - pos * pos)
    dw = p["damping"] * -(dpos * pos + pos * dpos)
    return [dvel, (dw * vel + w * dvel) - dpos]


def _rhs_pendulum(t, y, p):
    pos, vel = y
    return [vel, -9.81 / p["length"] * torch.sin(pos)]


def _rhs_jvp_pendulum(t, y, dy, p):
    pos, vel = y
    dpos, dvel = dy
    return [dvel, -9.81 / p["length"] * (torch.cos(pos) * dpos)]


def _rhs_logistic(t, y, p):
    (x,) = y
    return [p["growth_rate"] * x * (1.0 - x / p["carrying_capacity"])]


def _rhs_jvp_logistic(t, y, dy, p):
    (x,) = y
    (dx,) = dy
    r, k = p["growth_rate"], p["carrying_capacity"]
    return [(r * dx) * (1.0 - x / k) + (r * x) * -(dx / k)]


def _rhs_exponential(t, y, p):
    (x,) = y
    return [p["growth_factor"] * x]


def _rhs_jvp_exponential(t, y, dy, p):
    (dx,) = dy
    return [p["growth_factor"] * dx]


TILE_RHS = {
    "lotka_volterra": (_rhs_lotka_volterra, _rhs_jvp_lotka_volterra),
    "lorenz": (_rhs_lorenz, _rhs_jvp_lorenz),
    "van_der_pol": (_rhs_van_der_pol, _rhs_jvp_van_der_pol),
    "pendulum": (_rhs_pendulum, _rhs_jvp_pendulum),
    "logistic": (_rhs_logistic, _rhs_jvp_logistic),
    "exponential": (_rhs_exponential, _rhs_jvp_exponential),
}
for _variant in ("full", "reduced-1", "reduced-4"):
    _rhs = _make_rhs_hodgkin_huxley(_variant)
    TILE_RHS[f"hodgkin_huxley_{_variant}"] = (_rhs, _generic_jvp(_rhs))

# Ids of the instantiations in csrc/nll_fwd.cu and csrc/nll_bwd.cu, and the
# order in which a model functor reads its parameter rows.
_HH_PARAMS = tuple(hh._SINGLE_DEFAULTS)
_MODEL_IDS = {
    "lotka_volterra": 0,
    "hodgkin_huxley_reduced-4": 1,
    "hodgkin_huxley_reduced-1": 2,
    "hodgkin_huxley_full": 3,
    "lorenz": 4,
    "van_der_pol": 5,
    "pendulum": 6,
    "logistic": 7,
    "exponential": 8,
}
_MODEL_PARAMS = {
    "lotka_volterra": ("alpha", "beta", "gamma", "delta"),
    "hodgkin_huxley_reduced-4": _HH_PARAMS,
    "hodgkin_huxley_reduced-1": _HH_PARAMS,
    "hodgkin_huxley_full": _HH_PARAMS,
    "lorenz": ("sigma", "rho", "beta"),
    "van_der_pol": ("damping",),
    "pendulum": ("length",),
    "logistic": ("growth_rate", "carrying_capacity"),
    "exponential": ("growth_factor",),
}
_SOLVER_IDS = {"rkf45": 0, "kvaerno3": 1, "heun_euler": 2, "bs32": 3, "dopri65": 4}
_ERK_TABLEAUS = ("heun_euler", "bs32", "rkf45", "dopri65")
_ERK_MODELS = ("lotka_volterra", "lorenz", "van_der_pol", "pendulum", "logistic", "exponential")
_HH_MODELS = ("hodgkin_huxley_reduced-4", "hodgkin_huxley_reduced-1", "hodgkin_huxley_full")
# (model, solver) pairs instantiated, each with both kernels (nll_fwd and
# nll_bwd): every ERK tableau and Kvaerno3 on the models with a hand-written
# device RHS (csrc/ekf_chain.cuh; rkf45 on Lotka-Volterra in nll_fwd.cu /
# nll_bwd.cu, the other tableaus in nll_{fwd,bwd}_erk_*.cu, Kvaerno3 in
# nll_{fwd,bwd}_kv3_*.cu) and on the single-compartment Hodgkin-Huxley
# variants (Kvaerno3 in nll_{fwd,bwd}_hh*.cu, the ERK tableaus in
# nll_{fwd,bwd}_erk_hh*.cu).
_KERNELS = {(m, tab) for m in _ERK_MODELS + _HH_MODELS for tab in _ERK_TABLEAUS + ("kvaerno3",)}
# model -> the (state size n, observation size L) instantiated: every L in
# 1..n on the tile models, L = 1 on Hodgkin-Huxley
_SIZES = {
    "lotka_volterra": {(2, 1), (2, 2)},
    "lorenz": {(3, 1), (3, 2), (3, 3)},
    "van_der_pol": {(2, 1), (2, 2)},
    "pendulum": {(2, 1), (2, 2)},
    "logistic": {(1, 1)},
    "exponential": {(1, 1)},
    "hodgkin_huxley_reduced-4": {(4, 1)},
    "hodgkin_huxley_reduced-1": {(7, 1)},
    "hodgkin_huxley_full": {(8, 1)},
}
_DTYPE_IDS = {torch.float32: 0, torch.float64: 1}


def instantiated(model_name: str, solver_name: str, n: int, L: int) -> bool:
    """Whether nll_fwd and nll_bwd have an instantiation for this chain."""
    return (model_name, solver_name) in _KERNELS and (n, L) in _SIZES.get(model_name, ())


def no_grad_kernel(model_name: str, solver_name: str, n: int, L: int) -> str:
    """Why ``nll_bwd`` has no instantiation for this chain."""
    return (
        f"no nll_bwd instantiation for {model_name} with {solver_name} (n = {n}, L = {L}): the gradient kernel "
        f"is instantiated for every ERK tableau ({', '.join(_ERK_TABLEAUS)}) and Kvaerno3 on "
        f"{', '.join(_ERK_MODELS)} at every L in 1..n, and on the single-compartment Hodgkin-Huxley "
        "variants (n = 4, 7, 8) at L = 1; the entry points take make_nll + autograd (inference/nll.py) for "
        "every other configuration"
    )


def detect_uniform(obs):
    """(first, d, n_obs) for uniformly spaced observations read in row
    order, else None (the rule of ``pallas_ekf.py:401-412``)."""
    flags_np = np.asarray(obs.flags.cpu())
    obs_steps = np.nonzero(flags_np)[0]
    if len(obs_steps) < 2:
        return None
    diffs = np.diff(obs_steps)
    rows = np.asarray(obs.index_map.cpu())[obs_steps]
    if np.all(diffs == diffs[0]) and np.array_equal(rows, np.arange(len(obs_steps))):
        return (int(obs_steps[0]), int(diffs[0]), len(obs_steps))
    return None


def supports(model, solver, ekf, obs, grad: bool = False) -> bool:
    """Whether the CUDA kernels cover this configuration: the forward NLL
    (``nll_fwd``), and with ``grad`` its gradient (``nll_bwd``) as well.
    Both kernels are instantiated for the same chains, so ``grad`` does not
    change the answer; callers state which they need."""
    return (
        isinstance(solver, (ERK, Kvaerno3))
        and instantiated(model.name, solver.name, model.state_size, obs.obs_dim)
        # exact type: a subclass may compute a different likelihood
        and type(ekf) is SqrtEKF
        and getattr(ekf, "disable_cov_update", False)
        and detect_uniform(obs) is not None
    )


# --------------------------------------------------------------------------
# Small-matrix algebra on lists of tensors (pallas_ekf.py:195-263, 367-376)
# --------------------------------------------------------------------------

def _qr_r_lists(a_rows, eps: float):
    """R factor of a thin QR for an [m][n] list-of-tensors matrix: the
    Householder sweep of ops/small_qr.py with max-abs scaling and the
    zero-column guard. Its values are those of the tile math; its
    derivative differs from JAX's only at a column that is exactly zero,
    where the tile math's is NaN (the XLA path skips that QR at gamma = 0)."""
    m, n = len(a_rows), len(a_rows[0])
    scale = torch.abs(a_rows[0][0])
    for i in range(m):
        for j in range(n):
            if i or j:
                scale = torch.maximum(scale, torch.abs(a_rows[i][j]))
    scale = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    r = [[a_rows[i][j] / scale for j in range(n)] for i in range(m)]

    for j in range(n):
        col = [r[i][j] for i in range(j, m)]
        sigma_sq = col[0] * col[0]
        for c in col[1:]:
            sigma_sq = sigma_sq + c * c
        # the square root's derivative is taken as 0 where sigma_sq is 0 (a
        # column that is exactly zero, as float32 reaches when the covariance
        # underflows at gamma = 0), not 0/0: the reflection is skipped there
        # (`live` below), and its NaN would otherwise reach every entry
        pos = sigma_sq > 0
        sigma = torch.where(pos, torch.sqrt(torch.where(pos, sigma_sq, torch.ones_like(sigma_sq))),
                            torch.sqrt(sigma_sq).detach())
        sign = torch.where(col[0] >= 0, 1.0, -1.0).to(col[0].dtype)
        alpha = -sign * sigma
        v = [col[0] + sigma * sign] + col[1:]
        vnorm_sq = v[0] * v[0]
        for c in v[1:]:
            vnorm_sq = vnorm_sq + c * c
        live = vnorm_sq > eps
        inv = torch.where(live, 2.0 / torch.clamp(vnorm_sq, min=eps), torch.zeros_like(vnorm_sq))

        for k in range(j + 1, n):
            coeff = v[0] * r[j][k]
            for i in range(j + 1, m):
                coeff = coeff + v[i - j] * r[i][k]
            coeff = coeff * inv
            for i in range(j, m):
                r[i][k] = r[i][k] - v[i - j] * coeff
        r[j][j] = torch.where(live, alpha, col[0])
        for i in range(j + 1, m):
            r[i][j] = torch.zeros_like(r[i][j])

    return [[r[i][j] * scale for j in range(n)] for i in range(n)]


def _sqrt_sum_lists(eps: float, *factors):
    """Lower L (as [n][n] lists) with L L^T = sum F F^T; each factor is
    [n][k] (columns may differ): QR of the stacked transposes."""
    n = len(factors[0])
    rows = []
    for f in factors:
        for c in range(len(f[0])):
            rows.append([f[i][c] for i in range(n)])  # row c of F^T
    r = _qr_r_lists(rows, eps)
    return [[r[j][i] for j in range(n)] for i in range(n)]


def _fwd_sub(lmat, b):
    """z with L z = b (L lower)."""
    z = []
    for i in range(len(b)):
        acc = b[i]
        for j in range(i):
            acc = acc - lmat[i][j] * z[j]
        z.append(acc / lmat[i][i])
    return z


def _bwd_sub(lmat, b):
    """z with L^T z = b (L lower)."""
    n = len(b)
    z = [None] * n
    for i in reversed(range(n)):
        acc = b[i]
        for j in range(i + 1, n):
            acc = acc - lmat[j][i] * z[j]
        z[i] = acc / lmat[i][i]
    return z


# --------------------------------------------------------------------------
# Per-chain math
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChainMath:
    """Constants and per-lane math of one experiment: what the kernel bakes
    into its by-value struct, and the interval body its plain version runs.
    Matrices are nested lists of Python floats."""

    model_name: str
    rhs: Callable
    rhs_jvp: Callable
    solver: object  # ERK or Kvaerno3
    h: float
    t0: float
    first: int
    d: int
    n_obs: int
    n: int
    L: int
    dtype: torch.dtype
    x0: List[float]
    p0: List[List[float]]
    H: List[List[float]]
    R: List[List[float]]
    Q: List[List[float]]
    offsets: Dict[str, int]  # parameter name -> row of the [K, B] matrix
    k_params: int
    # False: step times from the step index (the tiles' rule); True: t += h
    # in the working type from t0 (the XLA path's rule, filters/sqrt_ekf.py:123)
    accumulate_time: bool = False

    @property
    def implicit(self) -> bool:
        return isinstance(self.solver, Kvaerno3)

    @property
    def eps(self) -> float:
        return (4.0 * torch.finfo(self.dtype).eps) ** 2

    @property
    def nll_const(self) -> float:
        return 0.5 * self.L * float(np.log(2.0 * np.pi))

    def t_start(self, j: int) -> float:
        """Time at the start of observation interval j, from the step index
        in double precision (make_nll_tiles, pallas_ekf.py:650)."""
        if j == 0:
            return self.t0
        return self.t0 + (self.first + 1 + (j - 1) * self.d) * self.h

    def _live_stages(self) -> List[bool]:
        """Stages whose slope reaches the propagated solution."""
        tab = self.solver.tableau
        s_count = tab.num_stages
        live = [False] * s_count
        for s in reversed(range(s_count)):
            live[s] = tab.b_sol[s] != 0.0 or any(
                live[u] and tab.a[u][s] != 0.0 for u in range(s + 1, s_count)
            )
        return live

    def _erk_step(self, t, x, cols, params):
        """The RK step and the tangents of its stages along the columns of P
        (pallas_ekf.py:171)."""
        n, tab, h = self.n, self.solver.tableau, self.h
        ks, dks = [], []
        for s, live in enumerate(self._live_stages()):
            if not live:
                ks.append(None)
                dks.append(None)
                continue
            yi, dyi = list(x), [list(col) for col in cols]
            for j in range(s):
                a = tab.a[s][j]
                if a == 0.0:
                    continue
                ha = h * a
                yi = [yi[k] + ha * ks[j][k] for k in range(n)]
                dyi = [[dyi[c][k] + ha * dks[j][c][k] for k in range(n)] for c in range(n)]
            t_s = t + tab.c[s] * h
            ks.append(self.rhs(t_s, yi, params))
            dks.append([self.rhs_jvp(t_s, yi, dyi[c], params) for c in range(n)])
        return ks, dks, tab.b_sol

    def _kvaerno3_step(self, t, x, cols, params):
        """The Kvaerno3 step (pallas_ekf.py:291-364): a base-point Jacobian
        and inverse drive ``newton_iters`` simplified-Newton iterations per
        implicit stage; the stage tangents follow the implicit-function rule
        dz = (I - h gamma J(z*))^-1 d(known), with J and the inverse taken
        at the stage solution z*, then dk = J(z*) dz. The small matrices
        are stacked [B, n, n] tensors here (``ops/small_inv.py``, batched
        products), so the plain version runs far fewer operations than an
        elementwise transliteration; the sums run in another order than the
        kernel's.

        Under autograd the derivative with respect to the parameters follows
        the stage solve's ``custom_jvp`` (pallas_ekf.py:301-332), not the
        Newton loop: the iterations run on detached values (the guess z0 and
        the base-point inverse carry no derivative, :314 and :345), and the
        solution is re-attached as z* + M^-1 (G - G.detach()), with
        G = known + h gamma f(t_i, z*, p) at z* held fixed and M^-1 the
        detached (I - h gamma J(z*))^-1. That has the value z* and the first
        derivative M^-1 dG, which is all reverse mode needs here: P's
        tangents are explicit (``jac_sol @ (minv_sol @ dknown)``), so J(z*)
        and its inverse are differentiated through the attached z."""
        n, h = self.n, self.h
        h_gamma = h * sdirk._GAMMA
        eye = torch.eye(n, dtype=x[0].dtype, device=x[0].device)

        def f(ti, z):  # [B, n] -> [B, n]
            return torch.stack(self.rhs(ti, list(z.unbind(-1)), params), -1)

        def slope_and_inverse(ti, z):
            jac = sdirk.jacobian(lambda zz: f(ti, zz), z)
            return f(ti, z), jac, inv_small(eye - h_gamma * jac)

        xs = torch.stack(x, -1)
        p_cols = torch.stack([torch.stack(col, -1) for col in cols], -1)  # [B, n, n]: column c of P
        k0, jac0, minv0 = slope_and_inverse(t, xs)
        minv0 = minv0.detach()
        ks, dks = [k0], [jac0 @ p_cols]
        for i in range(1, 4):
            t_i = t + sdirk._C[i] * h
            known, dknown = xs, p_cols
            for j in range(i):
                a = sdirk._A[i][j]
                if a != 0.0:
                    known = known + (h * a) * ks[j]
                    dknown = dknown + (h * a) * dks[j]
            with torch.no_grad():
                z = known + h_gamma * ks[i - 1]
                for _ in range(self.solver.newton_iters):
                    r = z - known - h_gamma * f(t_i, z)
                    z = z - (minv0 @ r[..., None])[..., 0]
            if torch.is_grad_enabled():
                # the value z*, the first derivative (I - h g J(z*))^-1 dG
                g_sol = known + h_gamma * f(t_i, z)
                with torch.no_grad():
                    minv_z = slope_and_inverse(t_i, z)[2]
                z = z + (minv_z @ (g_sol - g_sol.detach())[..., None])[..., 0]
            k_sol, jac_sol, minv_sol = slope_and_inverse(t_i, z)
            ks.append(k_sol)
            dks.append(jac_sol @ (minv_sol @ dknown))
        ks = [list(k.unbind(-1)) for k in ks]
        dks = [[list(dk[..., c].unbind(-1)) for c in range(n)] for dk in dks]
        return ks, dks, sdirk._B_SOL

    def predict(self, t, x, p_mat, params, qg):
        """One EKF predict at time t: the solver step with the columns of P
        carried as tangents through every stage, then
        P <- sqrt_sum(J P, gamma^1/2 Q) (pallas_ekf.py:480-498)."""
        n, h = self.n, self.h
        cols = [[p_mat[i][c] for i in range(n)] for c in range(n)]
        step = self._kvaerno3_step if self.implicit else self._erk_step
        ks, dks, b_sol = step(t, x, cols, params)
        x_next, p_cols = list(x), [list(col) for col in cols]
        for s, b in enumerate(b_sol):
            if b == 0.0:
                continue
            hb = h * b
            x_next = [x_next[k] + hb * ks[s][k] for k in range(n)]
            p_cols = [[p_cols[c][k] + hb * dks[s][c][k] for k in range(n)] for c in range(n)]
        p_pred = [[p_cols[j][i] for j in range(n)] for i in range(n)]
        return x_next, _sqrt_sum_lists(self.eps, p_pred, qg)

    def correct(self, x, p_mat, y_vals, r_const):
        """Joseph-form sqrt correct and innovation NLL (pallas_ekf.py:500-579)."""
        n, L, H, R = self.n, self.L, self.H, self.R
        y_hat = []
        for l in range(L):
            acc = None
            for k in range(n):
                if H[l][k] == 0.0:
                    continue
                term = H[l][k] * x[k]
                acc = term if acc is None else acc + term
            y_hat.append(acc if acc is not None else torch.zeros_like(x[0]))
        hp = [
            [sum(H[l][k] * p_mat[k][c] for k in range(n) if H[l][k] != 0.0) for c in range(n)]
            for l in range(L)
        ]
        s_sqrt = _sqrt_sum_lists(self.eps, hp, r_const)

        # K = (S^-T S^-1 H P P^T)^T : two substitutions and small products
        z_rows = [_bwd_sub(s_sqrt, _fwd_sub(s_sqrt, [H[l][k] for l in range(L)])) for k in range(n)]
        w = [[sum(z_rows[k][l] * p_mat[k][c] for k in range(n)) for c in range(n)] for l in range(L)]
        k_gain = [[sum(w[l][c] * p_mat[i][c] for c in range(n)) for l in range(L)] for i in range(n)]

        innov = [y_vals[l] - y_hat[l] for l in range(L)]
        x_new = [x[i] + sum(k_gain[i][l] * innov[l] for l in range(L)) for i in range(n)]

        # A = I - K H;  P_new = sqrt_sum(A P, K R)
        a_mat = [
            [
                (1.0 if i == j else 0.0)
                - sum(k_gain[i][l] * H[l][j] for l in range(L) if H[l][j] != 0.0)
                for j in range(n)
            ]
            for i in range(n)
        ]
        ap = [[sum(a_mat[i][k] * p_mat[k][c] for k in range(n)) for c in range(n)] for i in range(n)]
        kr = []
        for i in range(n):
            row = []
            for c in range(L):
                acc = torch.zeros_like(x[0])
                for l in range(L):
                    if R[l][c] != 0.0:
                        acc = acc + k_gain[i][l] * R[l][c]
                row.append(acc)
            kr.append(row)
        p_new = _sqrt_sum_lists(self.eps, ap, kr)

        z = _fwd_sub(s_sqrt, innov)
        half_maha = 0.5 * sum(zi * zi for zi in z)
        log_det = sum(torch.log(torch.abs(s_sqrt[l][l])) for l in range(L))
        return x_new, p_new, half_maha + self.nll_const + log_det

    def interval(self, x, p_mat, params, qg, r_const, y_vals, count, t_base):
        """``count`` predicts from time ``t_base`` (a zero-dim tensor),
        followed by one correct; step i starts at ``t_base + i h``
        (pallas_ekf.py:581-604), or with ``accumulate_time`` at
        ``t_base + h + ... + h``. Returns the time after the last step too."""
        t_acc = t_base
        for i in range(count):
            t = t_acc if self.accumulate_time else t_base + float(i) * self.h
            x, p_mat = self.predict(t, x, p_mat, params, qg)
            t_acc = t_acc + self.h
        return (*self.correct(x, p_mat, y_vals, r_const), t_acc)

    def rig_doubles(self) -> List[float]:
        """The constants in the layout of ``unpack_rig`` in csrc/ekf_chain.cuh."""
        flat = lambda m: [v for row in m for v in row]
        iters = self.solver.newton_iters if self.implicit else 0
        vals = [self.t0, self.h, self.first, self.d, self.n_obs, self.nll_const, iters, self.accumulate_time]
        vals += list(self.x0) + flat(self.p0) + flat(self.H) + flat(self.R) + flat(self.Q)
        vals += [self.offsets[k] for k in _MODEL_PARAMS[self.model_name]]
        return [float(v) for v in vals]


def build_chain_math(model, solver, spec, obs, state0, q_sqrt, accumulate_time: bool = False) -> ChainMath:
    uniform = detect_uniform(obs)
    if uniform is None:
        raise ValueError("the NLL kernel needs a uniform observation grid read in row order")
    if model.name not in TILE_RHS:
        raise ValueError(f"no tile RHS for model {model.name!r}")
    if not isinstance(solver, (ERK, Kvaerno3)):
        raise TypeError(f"unsupported solver for the NLL kernel: {solver!r}")
    first, d, n_obs = uniform
    rhs, rhs_jvp = TILE_RHS[model.name]

    to_list = lambda a: np.asarray(torch.as_tensor(a).cpu(), np.float64).tolist()
    offsets = {}
    off = 0
    for key, shape in zip(spec.keys, spec.shapes):
        size = int(np.prod(shape)) if shape else 1
        if size != 1:
            raise ValueError(f"vector parameter {key!r} is not supported by the NLL kernel")
        offsets[key] = off
        off += size

    n = int(state0.x.numel())
    return ChainMath(
        model_name=model.name,
        rhs=rhs,
        rhs_jvp=rhs_jvp,
        solver=solver,
        h=float(solver.h),
        t0=float(state0.t),
        first=first,
        d=d,
        n_obs=n_obs,
        n=n,
        L=int(obs.obs_dim),
        dtype=state0.x.dtype,
        x0=to_list(state0.x.reshape(n)),
        p0=to_list(state0.P_sqrt),
        H=to_list(obs.H),
        R=to_list(obs.R_sqrt),
        Q=to_list(q_sqrt),
        offsets=offsets,
        k_params=off,
        accumulate_time=accumulate_time,
    )


def nll_plain(cm: ChainMath, phys_t: torch.Tensor, ys: torch.Tensor, gamma_sqrt) -> torch.Tensor:
    """The plain PyTorch version of the kernel: phys_t [K, B], ys [n_obs, L]
    -> NLL [B], on whatever device the tensors are on. ``gamma_sqrt`` is a
    scalar or a [B] tensor."""
    like = phys_t[0]
    gamma_sqrt = torch.as_tensor(gamma_sqrt, dtype=phys_t.dtype, device=phys_t.device)
    params = {key: phys_t[row] for key, row in cm.offsets.items()}
    qg = [[gamma_sqrt * cm.Q[i][j] for j in range(cm.n)] for i in range(cm.n)]
    r_const = [[torch.full_like(like, cm.R[i][j]) for j in range(cm.L)] for i in range(cm.L)]
    x = [torch.full_like(like, v) for v in cm.x0]
    p_mat = [[torch.full_like(like, v) for v in row] for row in cm.p0]

    def y(j):
        return [ys[j, l] for l in range(cm.L)]

    def t_base(j, t_acc):
        return t_acc if cm.accumulate_time else like.new_full((), cm.t_start(j))

    t_acc = like.new_full((), cm.t0)
    x, p_mat, nll, t_acc = cm.interval(x, p_mat, params, qg, r_const, y(0), cm.first + 1, t_base(0, t_acc))
    for j in range(1, cm.n_obs):
        x, p_mat, nlg, t_acc = cm.interval(x, p_mat, params, qg, r_const, y(j), cm.d, t_base(j, t_acc))
        nll = nll + nlg
    return nll


def nll_grad_plain(cm: ChainMath, phys_t: torch.Tensor, ys: torch.Tensor, gamma_sqrt,
                   g: torch.Tensor, rows: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the gradient kernel: reverse-mode autograd through
    :func:`nll_plain` (for a Kvaerno3 step through the stage-solve rule).
    Returns ``(dphys [K, B], dgamma)``, the cotangent ``g`` [B] pulled back to
    the parameter rows and to ``gamma_sqrt``; ``dgamma`` has the shape of
    ``gamma_sqrt`` (a scalar sums over lanes, a [B] tensor gives each lane's
    share). ``rows`` are the parameter rows asked for (default: every row);
    the others are zero, as the kernel leaves them."""
    with torch.enable_grad():
        phys = phys_t.detach().requires_grad_(True)
        gs = torch.as_tensor(gamma_sqrt, dtype=phys_t.dtype, device=phys_t.device)
        gs = gs.detach().clone().requires_grad_(True)
        nll = nll_plain(cm, phys, ys, gs)
        dphys, dgamma = torch.autograd.grad(nll, (phys, gs), grad_outputs=g.to(nll.dtype))
    if rows is not None:
        keep = torch.zeros(cm.k_params, dtype=torch.bool, device=dphys.device)
        keep[list(rows)] = True
        dphys = torch.where(keep[:, None], dphys, torch.zeros_like(dphys))
    return dphys, dgamma


def physical_rows(spec, dtype: torch.dtype, p_norm_b: torch.Tensor) -> torch.Tensor:
    """Normalized [B, P_opt] -> physical parameter rows [K, B] in ``dtype``."""
    phys = spec.flatten(spec.to_params(p_norm_b.to(dtype))).to(dtype)
    return phys.T.contiguous()


def _check_rows(cm: ChainMath, phys_t: torch.Tensor, ys: torch.Tensor) -> int:
    """Validates the [K, B] parameter rows a kernel takes; returns B."""
    if not phys_t.is_cuda or phys_t.dtype not in _DTYPE_IDS:
        raise ValueError(f"the kernel takes float32/float64 CUDA tensors, got {phys_t.dtype} on {phys_t.device}")
    if phys_t.dim() != 2 or phys_t.shape[0] != cm.k_params or not phys_t.is_contiguous():
        raise ValueError(f"phys_t must be a contiguous [{cm.k_params}, B] tensor, got {tuple(phys_t.shape)}")
    batch = phys_t.shape[1]
    if not 0 < batch < 2**31:
        raise ValueError(f"batch size {batch} out of range")
    if ys.device != phys_t.device or ys.dtype != phys_t.dtype:
        raise ValueError(f"observations on {ys.device}/{ys.dtype}, parameters on {phys_t.device}/{phys_t.dtype}")
    return batch


def _check_device(t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"no NLL kernel for device {t.device}")


class NllFwd:
    """``nll_b(p_norm_b [B, P_opt], gamma_sqrt) -> [B]`` through the forward
    NLL kernel, differentiable through the gradient kernel (:attr:`grad`):
    launched on CUDA tensors, the plain versions on CPU tensors. Entered
    from normalized parameters, the backward asks the gradient kernel for
    the optimized rows only (``spec.opt_indices``): the other rows are
    constants of ``p_norm_b``, so their cotangent cannot reach it."""

    name = "nll_fwd"

    def __init__(self, cm: ChainMath, spec, ys: torch.Tensor):
        self.cm = cm
        self.spec = spec
        self.ys = ys[: cm.n_obs].to(cm.dtype).contiguous()
        self._rig = (ctypes.c_double * len(cm.rig_doubles()))(*cm.rig_doubles())
        self.opt_rows = tuple(int(r) for r in spec.opt_indices.tolist())
        self.grad = NllGrad(self)

    def physical(self, p_norm_b: torch.Tensor) -> torch.Tensor:
        """Normalized [B, P_opt] -> physical parameter rows [K, B]."""
        return physical_rows(self.spec, self.cm.dtype, p_norm_b)

    def __call__(self, p_norm_b: torch.Tensor, gamma_sqrt) -> torch.Tensor:
        gs = torch.as_tensor(gamma_sqrt, dtype=self.cm.dtype)
        return NllKernelFunction.apply(self.physical(p_norm_b), gs, self, self.opt_rows)

    def forward(self, phys_t: torch.Tensor, gamma_sqrt) -> torch.Tensor:
        """NLL [B] of the rows phys_t [K, B]: the kernel or its plain version."""
        if phys_t.is_cuda:
            return self.launch(phys_t, gamma_sqrt)
        _check_device(phys_t)
        return nll_plain(self.cm, phys_t, self.ys, gamma_sqrt)

    def launch(self, phys_t: torch.Tensor, gamma_sqrt) -> torch.Tensor:
        """One kernel launch on the current stream: phys_t [K, B] -> [B]."""
        cm = self.cm
        batch = _check_rows(cm, phys_t, self.ys)
        lib = load_library()
        out = torch.empty(batch, dtype=phys_t.dtype, device=phys_t.device)
        with torch.cuda.device(phys_t.device):
            stream = torch.cuda.current_stream(phys_t.device).cuda_stream
            err = lib.odeuq_nll_fwd(
                _DTYPE_IDS[phys_t.dtype],
                cm.n,
                cm.L,
                _MODEL_IDS[cm.model_name],
                _SOLVER_IDS[cm.solver.name],
                phys_t.data_ptr(),
                cm.k_params,
                batch,
                self.ys.data_ptr(),
                self._rig,
                float(gamma_sqrt),
                out.data_ptr(),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"nll_fwd launch failed ({err}): {lib.odeuq_error_string(err).decode()}")
        count_launch(self.name, cm)
        return out


class NllGrad:
    """``(dphys [K, B], dgamma)`` for the cotangent ``g`` [B] of the NLL of the
    rows phys_t [K, B], through the gradient kernel on CUDA tensors and
    :func:`nll_grad_plain` on CPU tensors. ``rows`` lists the parameter rows
    to differentiate (default: every row, as ``bwd_kernel`` gives them); the
    rows not asked for are zero, and the kernel launches no thread for
    them. ``dgamma`` is a scalar, or None when ``with_dgamma`` is false (the
    kernel then skips that direction). Raises on either device for a chain
    without a gradient instantiation."""

    name = "nll_bwd"

    def __init__(self, fwd: NllFwd):
        self.cm = fwd.cm
        self.ys = fwd.ys
        self._rig = fwd._rig

    def __call__(self, phys_t: torch.Tensor, gamma_sqrt, g: torch.Tensor, with_dgamma: bool = True,
                 rows: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        self._check_instantiated()
        if phys_t.is_cuda:
            dphys, dgamma = self.launch(phys_t, gamma_sqrt, g, with_dgamma, rows)
            return dphys, (dgamma.sum() if with_dgamma else None)
        _check_device(phys_t)
        dphys, dgamma = nll_grad_plain(self.cm, phys_t, self.ys, gamma_sqrt, g, rows)
        return dphys, (dgamma if with_dgamma else None)

    def _check_instantiated(self) -> None:
        """Raises for a chain the gradient kernel has no instantiation for,
        on either device (the CPU route stands in for the kernel only)."""
        cm = self.cm
        if not instantiated(cm.model_name, cm.solver.name, cm.n, cm.L):
            raise NotImplementedError(no_grad_kernel(cm.model_name, cm.solver.name, cm.n, cm.L))

    def launch(self, phys_t: torch.Tensor, gamma_sqrt, g: torch.Tensor, with_dgamma: bool = True,
               rows: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One kernel launch on the current stream: ``(dphys [K, B], each
        lane's share of dgamma [B] or None)``, one thread per (lane,
        direction). Raises for a chain without a gradient instantiation."""
        cm = self.cm
        self._check_instantiated()
        batch = _check_rows(cm, phys_t, self.ys)
        g = g.to(phys_t.dtype).contiguous()
        if g.shape != (batch,) or g.device != phys_t.device:
            raise ValueError(f"g must be a [{batch}] tensor on {phys_t.device}, got {tuple(g.shape)} on {g.device}")
        rows = tuple(range(cm.k_params)) if rows is None else tuple(int(r) for r in rows)
        if len(set(rows)) != len(rows) or any(not 0 <= r < cm.k_params for r in rows) or not (rows or with_dgamma):
            raise ValueError(f"rows must be distinct parameter rows in [0, {cm.k_params}), got {rows}")
        lib = load_library()
        dphys = (torch.empty_like if len(rows) == cm.k_params else torch.zeros_like)(phys_t)
        dgamma = torch.empty(batch, dtype=phys_t.dtype, device=phys_t.device) if with_dgamma else None
        with torch.cuda.device(phys_t.device):
            stream = torch.cuda.current_stream(phys_t.device).cuda_stream
            err = lib.odeuq_nll_bwd(
                _DTYPE_IDS[phys_t.dtype],
                cm.n,
                cm.L,
                _MODEL_IDS[cm.model_name],
                _SOLVER_IDS[cm.solver.name],
                phys_t.data_ptr(),
                cm.k_params,
                batch,
                self.ys.data_ptr(),
                self._rig,
                float(gamma_sqrt),
                g.data_ptr(),
                (ctypes.c_int * max(len(rows), 1))(*rows),
                len(rows),
                dphys.data_ptr(),
                None if dgamma is None else dgamma.data_ptr(),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"nll_bwd launch failed ({err}): {lib.odeuq_error_string(err).decode()}")
        count_launch(self.name, cm)
        return dphys, dgamma


class NllKernelFunction(torch.autograd.Function):
    """NLL [B] of the rows phys_t [K, B] at the scalar ``gamma_sqrt``: the
    forward runs ``fwd`` (:class:`NllFwd`), the backward runs ``fwd.grad``
    (:class:`NllGrad`) with the incoming cotangent, on the parameter
    ``rows`` (None: every row; the others get a zero gradient)."""

    @staticmethod
    def forward(ctx, phys_t, gamma_sqrt, fwd, rows=None):
        ctx.save_for_backward(phys_t, gamma_sqrt)
        ctx.fwd, ctx.rows = fwd, rows
        return fwd.forward(phys_t.contiguous(), gamma_sqrt)

    @staticmethod
    def backward(ctx, g):
        phys_t, gamma_sqrt = ctx.saved_tensors
        dphys, dgamma = ctx.fwd.grad(phys_t.contiguous(), gamma_sqrt, g, ctx.needs_input_grad[1], ctx.rows)
        if dgamma is not None:
            dgamma = dgamma.to(gamma_sqrt.device)
        return dphys, dgamma, None, None


def make_nll_cuda(model, solver, ekf, spec, obs, state0, num_steps: int, q_sqrt,
                  accumulate_time: bool = False) -> NllFwd:
    """Builds the kernel wrapper for a configuration :func:`supports` covers.
    ``q_sqrt`` [n, n] is a constant of the experiment; the tempering scale
    ``gamma_sqrt`` is a call argument. ``accumulate_time`` switches the step
    times from the tiles' step-index rule to the XLA path's running sum,
    which the entry points run."""
    del num_steps  # the uniform grid fixes the horizon that matters
    if not supports(model, solver, ekf, obs):
        raise ValueError("configuration not covered by the NLL kernel (see supports())")
    cm = build_chain_math(model, solver, spec, obs, state0, q_sqrt, accumulate_time)
    return NllFwd(cm, spec, obs.ys)


def make_nll_tiles(model, solver, ekf, spec, obs, state0, num_steps: int, q_sqrt,
                   accumulate_time: bool = False) -> Callable:
    """The plain version alone, on any device, for any ERK tableau or
    Kvaerno3 and any size: ``nll_b(p_norm_b [B, P_opt], gamma_sqrt) -> [B]``."""
    del num_steps
    if not getattr(ekf, "disable_cov_update", False):
        raise ValueError("the tile NLL covers disable_cov_update=True only")
    cm = build_chain_math(model, solver, spec, obs, state0, q_sqrt, accumulate_time)
    ys = obs.ys[: cm.n_obs].to(cm.dtype)

    def nll_b(p_norm_b: torch.Tensor, gamma_sqrt) -> torch.Tensor:
        return nll_plain(cm, physical_rows(spec, cm.dtype, p_norm_b), ys, gamma_sqrt)

    return nll_b
