"""Probabilistic-solve drivers: unroll a filter over the time grid (port of
``ode_uncertainty_tpu/inference/filter_run.py``).

Each driver returns ``run(state0, ...) -> (final state, trajectory)``, the
trajectory stacking the initial state and every ``save_every``-th state on a
new leading axis (``utils/scan.py``). A step is a predict, then a correct
where the observation grid has a point (the flags are read to the host once
per run). On the GPU each step is one replay of a CUDA graph
(``utils/scan.scan_plan``). Prediction-only runs pass
:func:`~ode_uncertainty_tpu_torch.inference.observations.empty_obs_model`.
"""

from __future__ import annotations

import torch

from ode_uncertainty_tpu_torch.filters.particle import ParticleFilter, PFState
from ode_uncertainty_tpu_torch.filters.sqrt_ekf import SqrtEKF
from ode_uncertainty_tpu_torch.models.base import ODEModel
from ode_uncertainty_tpu_torch.utils.scan import scan_plan, scan_save


def _filter_loop(predict, correct, num_steps: int, save_every: int, dense: bool = False):
    """``run(state0, *predict_args, obs)`` over ``num_steps`` steps,
    correcting against ``obs`` where its flags are set (with R = R_sqrt
    R_sqrt^T when ``dense``, else R_sqrt). On the GPU each step replays
    the CUDA graph of its kind, predict or predict and correct
    (``utils/scan.scan_plan``)."""

    def run(state0, *args):
        *args, obs = args
        r = obs.R_sqrt @ obs.R_sqrt.T if dense else obs.R_sqrt
        flags = obs.flags.cpu().tolist()
        rows = obs.index_map.cpu().tolist()

        def step(state, kind, *y):
            state = predict(state, *args)
            return correct(state, obs.H, y[0], r) if kind == "correct" else state

        def plan(idx):
            return ("correct", (obs.ys[rows[idx]],)) if flags[idx] else ("predict", ())

        return scan_plan(step, plan, state0, num_steps, save_every)

    return run


def make_ekf_run(ekf: SqrtEKF, solver, model: ODEModel, num_steps: int, save_every: int = 1):
    """Returns ``run(state0, params, q_sqrt, gamma_sqrt, obs) -> (final
    EKFState, trajectory EKFState with a leading time axis)``."""
    return _filter_loop(ekf.make_predict(solver, model.rhs), ekf.make_correct(unrolled=True), num_steps, save_every)


def make_ekf_run_static(ekf: SqrtEKF, solver, model: ODEModel, num_steps: int, save_every: int = 1):
    """Conrad-baseline trajectory: ``run(state0, params, sigma, obs)`` with
    fixed sigma^2 * I process noise."""
    return _filter_loop(ekf.make_predict_static(solver, model.rhs), ekf.make_correct(unrolled=True), num_steps, save_every)


def make_dense_run(flt, solver, model: ODEModel, num_steps: int, save_every: int = 1):
    """Trajectory driver for the dense-covariance filters (DenseEKF / UKF):
    ``run(state0, params, q, gamma, obs)``, the same loop as
    :func:`make_ekf_run` with full-covariance noise arguments."""
    return _filter_loop(flt.make_predict(solver, model.rhs), flt.make_correct(), num_steps, save_every, dense=True)


def make_gmm_run(gmm, solver, model: ODEModel, num_steps: int, save_every: int = 1):
    """Trajectory driver for the Gaussian-mixture sqrt-EKF: ``run(state0,
    params, q_sqrt, gamma_sqrt, obs)``; the trajectory holds the whole bank."""
    return _filter_loop(gmm.make_predict(solver, model.rhs), gmm.make_correct(), num_steps, save_every)


def make_pf_run(pf: ParticleFilter, solver, model: ODEModel, num_steps: int, save_every: int = 1):
    """Particle-perturbation trajectory (prediction only):
    ``run(state0, params, generator)``; the generator advances every step."""
    predict = pf.make_predict(solver, model.rhs)

    def run(state0: PFState, params, generator: torch.Generator):
        return scan_save(lambda s, idx: predict(s, params, generator), state0, num_steps, save_every)

    return run
