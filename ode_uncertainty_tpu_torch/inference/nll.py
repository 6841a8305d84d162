"""Filter negative log-likelihood of ODE parameters, and the filter-free
baseline NLL (port of ``ode_uncertainty_tpu/inference/nll.py``).

Runs the square-root EKF over the time grid with a batch of candidate
parameters and sums the innovation Gaussian NLL at every observation. The
gradient is autograd's, through the linearization (``torch.func.jvp``), the
QR factorizations and, for the Kvaerno3 step, the stage-solve rule
(``solvers/sdirk.py``) at first and second order.

The observation flags are host data, so the time loop is unrolled in
Python: on a uniform grid (observations every d steps, rows in order) as
spans of d predicts and a correct, else step by step, each step with an
observation followed by its correct. Steps after the last observation add
nothing to the NLL and are not run. Checkpointing
(``torch.utils.checkpoint``, non-reentrant) bounds the memory of the
backward pass as the JAX package's ``jax.checkpoint`` does: one checkpoint
per observation interval on the uniform path, chunks of about sqrt(T) steps
on the general path. It changes memory, never values.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ode_uncertainty_tpu_torch.filters.sqrt_ekf import EKFState, SqrtEKF
from ode_uncertainty_tpu_torch.inference.observations import ObsModel
from ode_uncertainty_tpu_torch.inference.params import ParamSpec
from ode_uncertainty_tpu_torch.models.base import ODEModel
from ode_uncertainty_tpu_torch.ops.linearize import value_and_jacfwd
from ode_uncertainty_tpu_torch.ops.nll_kernel import detect_uniform
from ode_uncertainty_tpu_torch.ops.sqrt_linalg import nll_gaussian_sqrt


def _checkpointed(fn: Callable, on: bool) -> Callable:
    if not on:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def make_nll(
    model: ODEModel,
    solver,
    ekf: SqrtEKF,
    spec: ParamSpec,
    obs: ObsModel,
    state0: EKFState,
    num_steps: int,
    x0_raw: Optional[torch.Tensor] = None,
    initial_state_parametrized: bool = False,
    parameter_sensitivity: bool = False,
    remat: bool = False,
    chunk_size: Optional[int] = None,
    fast_path: bool = True,
) -> Callable:
    """Returns ``nll(p_norm_opt [..., P_opt], q_sqrt [n, n], gamma_sqrt) -> [...]``;
    ``gamma_sqrt`` is [] or one per lane, [..., 1, 1].

    Args:
        parameter_sensitivity: replace q_sqrt by per-state process-noise
            weights from the solver's parameter Jacobian at the initial
            state, lane by lane (reference ``inference/nll.py:92-106``).
        remat: checkpoint every step on the general path (every interval
            on the uniform one).
        chunk_size: steps per checkpointed chunk on the general path; by
            default ``max(16, round(sqrt(num_steps)))`` from 256 steps on.
            On the uniform path, 1 turns the per-interval checkpoint off.
        fast_path: take the uniform path where the grid allows it.
    """
    predict = ekf.make_predict(solver, model.rhs)
    correct = ekf.make_correct()
    n = state0.x.shape[-2] * state0.x.shape[-1]
    uniform = detect_uniform(obs) if fast_path else None
    flags = np.asarray(obs.flags.cpu())
    rows = np.asarray(obs.index_map.cpu())
    obs_steps = np.nonzero(flags[:num_steps])[0]

    def nll(p_norm_opt: torch.Tensor, q_sqrt: torch.Tensor, gamma_sqrt) -> torch.Tensor:
        params = spec.to_params(p_norm_opt)
        batch = p_norm_opt.shape[:-1]
        x0 = state0.x
        if initial_state_parametrized:
            if x0_raw is None:
                raise ValueError("initial_state_parametrized requires x0_raw")
            x0 = model.build_initial_value(x0_raw, params).to(x0.dtype)
        state = state0.replace(x=x0.expand(*batch, *x0.shape[-2:]))
        q_eff = sensitivity_weights(params, state) if parameter_sensitivity else q_sqrt

        def correct_at(s, row):
            y = obs.ys[row]
            s2 = correct(s, obs.H, y, obs.R_sqrt)
            return s2, nll_gaussian_sqrt(y, s2.y_hat, s2.S_sqrt)

        def predict_span(s, count):
            for _ in range(count):
                s = predict(s, params, q_eff, gamma_sqrt)
            return s

        if uniform is not None:
            first, d, n_obs = uniform
            use_ckpt = remat or (num_steps >= 256 and chunk_size != 1)
            interval = _checkpointed(lambda s, j: correct_at(predict_span(s, d), j), use_ckpt)
            state, total = correct_at(predict_span(state, first + 1), 0)
            for j in range(1, n_obs):
                state, nlg = interval(state, j)
                total = total + nlg
            return total

        def step(s, idx):
            s = predict(s, params, q_eff, gamma_sqrt)
            if flags[idx]:
                return correct_at(s, int(rows[idx]))
            return s, None

        step_fn = _checkpointed(step, remat)

        def run(s, lo, hi):
            total = torch.zeros(batch, dtype=s.x.dtype, device=s.x.device)
            for idx in range(lo, hi):
                s, nlg = step_fn(s, idx)
                if nlg is not None:
                    total = total + nlg
            return s, total

        end = int(obs_steps[-1]) + 1 if len(obs_steps) else 0
        chunk = chunk_size
        if chunk is None and num_steps >= 256:
            chunk = max(16, int(round(num_steps**0.5)))
        if not (chunk and chunk > 1 and num_steps >= 2 * chunk):
            return run(state, 0, end)[1]
        run_chunk = _checkpointed(run, True)
        total = torch.zeros(batch, dtype=state.x.dtype, device=state.x.device)
        whole = (num_steps // chunk) * chunk
        for lo in range(0, min(end, whole), chunk):
            state, part = run_chunk(state, lo, min(lo + chunk, end))
            total = total + part
        if end > whole:  # the tail after the last whole chunk
            total = total + run(state, whole, end)[1]
        return total

    def sensitivity_weights(params, s0: EKFState) -> torch.Tensor:
        """diag(w) [..., n, n]: w = sum over the optimized parameters of
        |d x_next / d theta| at the initial state, scaled to sqrt(n) RMS."""

        def step_of_params(pf):
            x_next, _ = solver.step(model.rhs, spec.unflatten(pf), s0.t, s0.x)
            return x_next.reshape(*x_next.shape[:-2], n)

        flat0 = spec.flatten(params)
        _, jac = value_and_jacfwd(step_of_params, flat0)  # [..., n, P_full]
        w = (torch.abs(jac) * spec.opt_mask_full().to(jac.dtype)).sum(dim=-1)
        w = (n**0.5) * w / torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        return torch.diag_embed(w)

    return nll


def make_baseline_nll(
    model: ODEModel,
    solver,
    spec: ParamSpec,
    obs: ObsModel,
    t0,
    x0: torch.Tensor,
    num_steps: int,
    x0_raw: Optional[torch.Tensor] = None,
    initial_state_parametrized: bool = False,
) -> Callable:
    """Filter-free trajectory-fitting NLL (the classic least-squares
    baseline): integrate the ODE deterministically and score the flagged
    steps' observations under the fixed noise ``R_sqrt``.

    Returns ``nll(p_norm_opt [..., P_opt]) -> [...]``. Step ``idx`` starts at
    ``t0 + idx * h`` (the step index, as the reference's baseline computes
    it, not the running sum of the filter's predict). Steps after the last
    observation add nothing and are not run. Differentiable by autograd
    (through the Kvaerno3 stage-solve rule for the implicit step).
    """
    flags = np.asarray(obs.flags.cpu())
    rows = np.asarray(obs.index_map.cpu())
    obs_steps = np.nonzero(flags[:num_steps])[0]
    end = int(obs_steps[-1]) + 1 if len(obs_steps) else 0

    def nll(p_norm_opt: torch.Tensor) -> torch.Tensor:
        params = spec.to_params(p_norm_opt)
        batch = p_norm_opt.shape[:-1]
        x = x0
        if initial_state_parametrized:
            if x0_raw is None:
                raise ValueError("initial_state_parametrized requires x0_raw")
            x = model.build_initial_value(x0_raw, params).to(x0.dtype)
        x = x.expand(*batch, *x0.shape[-2:])
        t0_t = torch.as_tensor(t0, dtype=x0.dtype, device=x0.device)
        total = torch.zeros(batch, dtype=x0.dtype, device=x0.device)
        for idx in range(end):
            x, _ = solver.step(model.rhs, params, t0_t + idx * solver.h, x)
            if flags[idx]:
                y_hat = x.reshape(*batch, -1) @ obs.H.T
                total = total + nll_gaussian_sqrt(obs.ys[int(rows[idx])], y_hat, obs.R_sqrt)
        return total

    return nll
