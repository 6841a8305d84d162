"""Tempered maximum-likelihood estimation on the device L-BFGS, the NLL
landscape and the estimation result (port of
``ode_uncertainty_tpu/inference/estimate.py``).

The objective is batched over a leading lane axis: ``nll(p [B, P_opt],
gamma_sqrt) -> [B]`` (the NLL kernels' wrapper, differentiable through
their autograd Function, or the port's ``make_nll`` at a fixed q_sqrt).
Restarts are the lanes of one :func:`~ode_uncertainty_tpu_torch.inference.lbfgs.lbfgs_box`
run; the tempering stages loop on the host, each from the previous
stage's optima. The reference's two stage modes (one program per sweep or
per segment) are kept as the two ways of running a stage, in one call or in
segments sized toward a wall-clock target; both give the same values.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ode_uncertainty_tpu_torch.inference.lbfgs import (
    lbfgs_box,
    lbfgs_box_init,
    lbfgs_box_segment,
    lbfgs_result,
)
from ode_uncertainty_tpu_torch.inference.params import ParamSpec


class EstimationResult(NamedTuple):
    """Result arrays (the H5 schema of the reference)."""

    params_inits: np.ndarray  # [R, P_opt] physical initial params
    params_optims: np.ndarray  # [R, S, P_opt] physical optima per stage
    nll_optims: np.ndarray  # [R, S]
    num_lbfgs_iters: np.ndarray  # [R, S]
    num_nll_evals: np.ndarray  # [R, S]
    gammas: np.ndarray  # [S]


def _gamma_sqrt(gamma, dtype) -> torch.Tensor:
    """gamma^1/2 as a CPU scalar of ``dtype`` (the objective reads it on the
    host: no device read per evaluation)."""
    return torch.sqrt(torch.as_tensor(gamma, dtype=dtype).cpu())


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _run_segments(fun, p0_norm, max_iter, tol, history, seg: float, target_s: float, min_seg: int):
    """One stage from p0_norm [R, P] as L-BFGS segments: each runs the lanes
    ``max(min_seg, seg)`` iterations past the slowest lane's count (at most
    to ``max_iter``), and ``seg`` is scaled toward ``target_s`` wall seconds
    a segment. Returns the final state."""
    state = lbfgs_box_init(fun, p0_norm, 0.0, 1.0, history, tol)
    limit = int(state.iters.min()) + max(min_seg, int(seg))
    while True:
        t0 = time.perf_counter()
        state = lbfgs_box_segment(fun, state, limit, 0.0, 1.0, tol=tol)
        _sync(state.x)
        elapsed = time.perf_counter() - t0
        if bool(torch.all(state.done | (state.iters >= max_iter))):
            return state
        seg = min(max(float(min_seg), int(seg) * target_s / max(elapsed, 1e-3)), float(max_iter))
        limit = min(limit + max(min_seg, int(seg)), max_iter)


def make_tempered_estimator(
    nll: Callable,
    spec: ParamSpec,
    max_iter: int = 200,
    tol: float = 1e-6,
    history: int = 10,
    stage_scan: bool = True,
):
    """Builds the batched tempered estimator.

    Args:
        nll: ``(p_norm_opt [B, P_opt], gamma_sqrt) -> [B]``.
        stage_scan: if True, each stage is one :func:`lbfgs_box` call; if
            False, each stage runs in segments sized toward 25 wall seconds
            (the reference's host-looped mode). The values are the same.

    Returns:
        ``estimate(p0_norm [R, P_opt], gammas [S]) -> EstimationResult``.
    """

    def run_stage(p, gamma):
        fun = lambda q: nll(q, _gamma_sqrt(gamma, p.dtype))
        if stage_scan:
            return lbfgs_box(fun, p, 0.0, 1.0, max_iter=max_iter, tol=tol, history=history)
        state = _run_segments(fun, p, max_iter, tol, history, seg=min(8, max(1, max_iter)), target_s=25.0,
                              min_seg=2)
        return lbfgs_result(state, 0.0, 1.0, tol)

    def estimate(p0_norm: torch.Tensor, gammas) -> EstimationResult:
        p, outs = p0_norm, []
        for gamma in gammas:
            res = run_stage(p, gamma)
            p = res.x
            outs.append(res)
        host = lambda t: t.detach().cpu().numpy()
        stack = lambda field: np.stack([host(getattr(o, field)) for o in outs], axis=1)
        return EstimationResult(
            params_inits=host(spec.opt_to_physical(p0_norm)),
            params_optims=host(spec.opt_to_physical(torch.stack([o.x for o in outs], dim=1))),
            nll_optims=stack("f"),
            num_lbfgs_iters=stack("iters"),
            num_nll_evals=stack("n_fev"),
            gammas=np.asarray(torch.as_tensor(gammas).cpu()),
        )

    return estimate


def make_stage_optimizer(
    nll: Callable,
    max_iter: int = 200,
    tol: float = 1e-6,
    history: int = 10,
    target_s: float = 25.0,
    initial_segment: int = 1,
):
    """Returns ``stage(p0_norm [R, P], gamma) -> LBFGSResult`` (tensors on
    p0_norm's device) running one tempering stage of the batched objective
    ``nll(p [B, P], gamma_sqrt) -> [B]`` as L-BFGS segments, the first of
    ``initial_segment`` iterations, each next one sized toward ``target_s``
    wall seconds. The sizing changes how long a segment runs, never the
    values."""

    def stage(p0_norm, gamma):
        fun = lambda q: nll(q, _gamma_sqrt(gamma, p0_norm.dtype))
        state = _run_segments(fun, p0_norm, max_iter, tol, history, seg=float(initial_segment),
                              target_s=target_s, min_seg=1)
        return lbfgs_result(state, 0.0, 1.0, tol)

    return stage


def make_nll_landscape(
    nll: Callable,
    q_sqrt: torch.Tensor,
    batch_size: int = 256,
    timings_out: list | None = None,
):
    """NLL grid evaluation.

    ``nll(p_batch [B, P_opt], q_sqrt, gamma_sqrt) -> [B]`` is batched over the
    leading dim. Returns ``landscape(p_norm_grid [G, P_opt], gammas [S]) ->
    [S, G]``; the grid is evaluated in chunks of ``batch_size`` points.

    ``timings_out``: when a list is given, each batch is synchronized and
    timed, appending ``(points_in_batch, seconds)`` per batch (in stage-major
    order); leaving it ``None`` keeps the launches asynchronous.
    """

    def landscape(p_norm_grid: torch.Tensor, gammas) -> torch.Tensor:
        chunks = torch.split(p_norm_grid, batch_size)
        device = p_norm_grid.device
        rows = []
        for gamma in gammas:
            gamma_sqrt = torch.sqrt(torch.as_tensor(gamma, dtype=p_norm_grid.dtype))
            if timings_out is None:
                rows.append(torch.cat([nll(c, q_sqrt, gamma_sqrt) for c in chunks]))
                continue
            parts = []
            for c in chunks:
                t0 = time.perf_counter()
                v = nll(c, q_sqrt, gamma_sqrt)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                timings_out.append((c.shape[0], time.perf_counter() - t0))
                parts.append(v)
            rows.append(torch.cat(parts))
        return torch.stack(rows)

    return landscape
