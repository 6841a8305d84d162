"""Tempered ODE parameter estimation entry point of the port (counterpart of
``scripts/run_parameter_estimation.py``). Subcommands:

  optimize — tempered maximum likelihood from restarts with the host L-BFGS
             (strong Wolfe, the default) or, with ``optimizer_mode=device``,
             the device L-BFGS (projected Armijo, ``inference/lbfgs.py``)
             in segments (``make_stage_optimizer``); writes the reference's
             keys (``params_inits``, ``params_optims``, ``nll_optims``, the
             iteration and evaluation counters, ``gammas``,
             ``wall_clock_s``, ...).
  evaluate — NLL landscape over a parameter grid per tempering stage; writes
             ``param_evals``, ``nll_evals``, ``gammas`` and ``timings``.

The kernels are the port's default route, where the JAX CLI's default is
its XLA ``make_nll`` (it takes its Pallas kernel only with ``--set
nll_impl=pallas``). When ``supports()`` holds and neither
``initial_state_parametrized`` nor ``parameter_sensitivity`` is on, the NLL
goes through the CUDA kernels of ``ops/nll_kernel.py`` (``nll_fwd``, and
for ``optimize``'s gradient ``nll_bwd``), or their plain versions on CPU
tensors; else, or with ``--set nll_impl=xla`` or ``--set
nll_fast_path=false``, through the port's ``make_nll`` (with autograd for
the gradient, through the Kvaerno3 stage-solve rule at second order for the
implicit step), which on the CPU runs about ten times slower than the plain
versions (its linearization goes through ``torch.func.jvp``).
``nll_fast_path`` reaches ``make_nll`` as the JAX CLI passes it (false: the
general step loop on a uniform grid too). Both routes advance the step time
as the running sum ``t += h`` in the working type, as the JAX CLI's XLA
``make_nll`` does. The result records the route taken. Results go to the
``output`` path: H5, or ``.npz`` for a path with that suffix.

Usage:
  python -m ode_uncertainty_tpu_torch.run_parameter_estimation optimize \\
      --experiment params/lotkavolterra2 [--set device=cpu] [--set output=out.npz]
  python -m ode_uncertainty_tpu_torch.run_parameter_estimation optimize \\
      --experiment params/lotkavolterra2 --set optimizer_mode=device [--set output=out.npz]
  python -m ode_uncertainty_tpu_torch.run_parameter_estimation optimize \\
      --experiment params/hodgkinhuxley1_r4 \\
      --set y_path=ode_uncertainty_tpu_torch/data/hodgkinhuxley_r4.npz [--set output=out.npz]
  python -m ode_uncertainty_tpu_torch.run_parameter_estimation optimize \\
      --experiment params/hodgkinhuxley7_full \\
      --set y_path=ode_uncertainty_tpu_torch/data/hodgkinhuxley_full.npz [--set output=out.npz]
  python -m ode_uncertainty_tpu_torch.run_parameter_estimation optimize \\
      --experiment params/hodgkinhuxley2_c2_r4 \\
      --set y_path=ode_uncertainty_tpu_torch/data/hodgkinhuxley_c2_r4.npz [--set output=out.npz]
  python -m ode_uncertainty_tpu_torch.run_parameter_estimation optimize \\
      --experiment params/pendulum \\
      --set 'filter_builder={"class_path": "SQRT_EKF", "init_args": {"disable_cov_update": True}}' \\
      --set y_path=ode_uncertainty_tpu_torch/data/pendulum.npz [--set output=out.npz]
  python -m ode_uncertainty_tpu_torch.run_parameter_estimation evaluate \\
      --experiment params/lotkavolterra2 [--set device=cpu] [--set tN=2] [--set output=out.h5]
  python -m ode_uncertainty_tpu_torch.run_parameter_estimation evaluate \\
      --experiment params/lotkavolterra2 --set nll_impl=xla [--set device=cpu] [--set tN=2]
  python -m ode_uncertainty_tpu_torch.run_parameter_estimation evaluate \\
      --experiment params/hodgkinhuxley1_r4 \\
      --set y_path=ode_uncertainty_tpu_torch/data/hodgkinhuxley_r4.npz [--set device=cpu --set tN=0.3]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ode_uncertainty_tpu_torch._common import build_p0_sqrt, build_x0, load_observations, num_steps_of
from ode_uncertainty_tpu_torch.inference import (
    EstimationResult,
    make_nll,
    make_nll_landscape,
    make_param_spec,
    make_stage_optimizer_host,
)
from ode_uncertainty_tpu_torch.inference.estimate import make_stage_optimizer
from ode_uncertainty_tpu_torch.ops.nll_kernel import make_nll_cuda, supports
from ode_uncertainty_tpu_torch.utils.carry import Rig
from ode_uncertainty_tpu_torch.utils.checkpoint import run_stage_grid
from ode_uncertainty_tpu_torch.utils.config import apply_runtime_config, config_cli, parse_literal
from ode_uncertainty_tpu_torch.utils.io import store_data


def build_rig(cfg, dtype, device) -> Rig:
    """The experiment's model, solver, filter, parameter box, observations and
    initial state (counterpart of ``_build_rig`` and ``scripts/_common.py``)."""
    model = cfg["ode_builder"]
    solver = cfg["solver_builder"]
    ekf = cfg["filter_builder"]
    num_steps = num_steps_of(cfg, solver)
    x0_raw, x0 = build_x0(cfg, model, dtype, device)
    n = x0.numel()
    obs, has_obs = load_observations(cfg, solver, num_steps, n, dtype, device)
    if not has_obs:
        raise ValueError("Estimation requires y_path and measurement_matrix")
    spec = make_param_spec(
        model.params, cfg["params_range"], cfg.get("params_optimized"), dtype=dtype, device=device
    )
    state0 = ekf.init_state(cfg.get("t0", 0.0), x0, build_p0_sqrt(cfg, n, dtype, device), obs.obs_dim)
    # absent/null weights mean unmasked tempering noise
    w_raw = parse_literal(cfg.get("gamma_noise_weights"))
    w = torch.ones(n, dtype=dtype, device=device) if w_raw is None else torch.as_tensor(w_raw, dtype=dtype, device=device)
    return Rig(model, solver, ekf, spec, obs, state0, torch.diag(w), num_steps, x0_raw)


# Restart batches beyond this are optimized in sequential chunks.
RESTART_CHUNK = 512


def batched_nll(rig: Rig, cfg, grad: bool = False):
    """``(nll_b(p [B, P_opt], gamma_sqrt) -> [B], on_kernels)``: the NLL
    kernels' wrapper (differentiable through nll_bwd) when they cover the
    configuration (with ``grad``, the gradient kernel too) and no estimation
    flag asks for more than they compute, else the port's make_nll at the
    rig's q_sqrt. The kernels' wrapper runs the step times as the running
    sum ``t += h`` in the working type (``accumulate_time``), the rule of
    the JAX CLI's XLA ``make_nll`` and of the port's ``make_nll``, so that
    both routes compute what the reference computes in each working type
    (the kernels' default, the step index, can switch the Hodgkin-Huxley
    stimulus on or off one step apart).

    ``initial_state_parametrized`` builds each lane's initial state from its
    parameters and ``parameter_sensitivity`` (reference
    ``inference/nll.py:92-106``) weights the process noise per lane by the
    step's parameter Jacobian; the kernels (one x0 and one q_sqrt for every
    lane) compute neither, so either flag takes make_nll. So do
    ``nll_impl=xla`` and ``nll_fast_path`` false, the keys that ask for the
    JAX CLI's default route; ``nll_fast_path`` reaches make_nll as the JAX
    CLI passes it."""
    init_param = bool(cfg.get("initial_state_parametrized", False))
    sensitivity = bool(cfg.get("parameter_sensitivity", False))
    fast_path = bool(cfg.get("nll_fast_path", True))
    kernels_allowed = fast_path and cfg.get("nll_impl") != "xla"
    if (kernels_allowed and not (init_param or sensitivity)
            and supports(rig.model, rig.solver, rig.ekf, rig.obs, grad=grad)):
        return make_nll_cuda(
            rig.model, rig.solver, rig.ekf, rig.spec, rig.obs, rig.state0, rig.num_steps, rig.q_sqrt,
            accumulate_time=True,
        ), True
    nll = make_nll(
        rig.model,
        rig.solver,
        rig.ekf,
        rig.spec,
        rig.obs,
        rig.state0,
        rig.num_steps,
        x0_raw=rig.x0_raw,
        initial_state_parametrized=init_param,
        parameter_sensitivity=sensitivity,
        fast_path=fast_path,
    )
    return (lambda p, gamma_sqrt: nll(p, rig.q_sqrt, gamma_sqrt)), False


def gammas_of(cfg, dtype) -> torch.Tensor:
    sched = cfg["gamma_noise_schedule"]
    return sched.gammas(cfg.get("num_tempering_stages", 10), cfg.get("final_gamma_zero", True)).to(dtype)


def initial_restarts(cfg, spec, dtype) -> torch.Tensor:
    """[R, P_opt] normalized restarts: ``num_random_runs`` uniform draws from a
    ``torch.Generator`` seeded with ``seed``, or, for 0 runs, the defaults."""
    runs = cfg.get("num_random_runs", 0)
    if runs > 0:
        gen = torch.Generator(device=spec.defaults_flat.device).manual_seed(cfg.get("seed", 7))
        return spec.sample_norm(gen, runs).to(dtype)
    return spec.defaults_norm_opt().to(dtype)[None, :]


def optimize(cfg) -> dict:
    """Tempered estimation of ``cfg``; stores and returns the results, plus
    the route, the optimizer mode and a record of each (restart chunk x
    stage) unit."""
    rt = apply_runtime_config(cfg)
    dtype, device = rt["dtype"], rt["device"]
    rig = build_rig(cfg, dtype, device)
    spec = rig.spec
    gammas = gammas_of(cfg, dtype)
    p0 = initial_restarts(cfg, spec, dtype)

    nll_b, on_kernels = batched_nll(rig, cfg, grad=True)
    route = "nll_fwd + nll_bwd kernels" if on_kernels else "make_nll + autograd"

    # per-unit record: wall seconds, value-and-gradient dispatches and the
    # widest, lanes that reached the iteration limit
    max_iter = cfg.get("lbfgs_maxiter", 200)
    widths: list = []
    units: list = []

    def counted(p, gamma_sqrt):
        widths.append(p.shape[0])
        return nll_b(p, gamma_sqrt)

    # the host strong-Wolfe L-BFGS is the default; "device" runs the
    # device L-BFGS (projected Armijo) in segments, as the JAX CLI does
    mode = cfg.get("optimizer_mode", "host")
    tol = cfg.get("lbfgs_tol", 1e-4)
    if mode == "device":
        device_stage = make_stage_optimizer(counted, max_iter=max_iter, tol=tol)

        def stage_opt(p_norm, gamma, unit_key=None):
            res = device_stage(p_norm, gamma)
            return type(res)(*(t.cpu().numpy() for t in res))
    else:
        stage_opt = make_stage_optimizer_host(
            None,
            rig.q_sqrt,
            nll_batched=counted,
            max_iter=max_iter,
            tol=tol,
            state_prefix=str(cfg["output"]),
            progress_every=int(cfg.get("lbfgs_progress_every", 1)),
        )

    def stage(p_norm, gamma, unit_key=None):
        n0, t0 = len(widths), time.perf_counter()
        res = stage_opt(p_norm, gamma, unit_key=unit_key)
        units.append({"unit": unit_key, "gamma": float(gamma), "seconds": time.perf_counter() - t0,
                      "dispatches": len(widths) - n0, "widest": max(widths[n0:], default=0), "lanes": len(res.iters),
                      "lanes_at_max_iter": int((res.iters >= max_iter).sum())})
        return res

    t_start = time.perf_counter()
    merged = run_stage_grid(
        cfg["output"],
        p0,
        gammas,
        stage,
        spec.opt_to_physical,
        chunk=int(cfg.get("restart_chunk", RESTART_CHUNK)),
        resume=cfg.get("resume", True),
        tag=str(cfg.get("tag", cfg["output"])),
    )
    wall = time.perf_counter() - t_start
    fields = ("params_inits", "params_optims", "nll_optims", "num_lbfgs_iters", "num_nll_evals")
    res = EstimationResult(*[merged[f] for f in fields], gammas=gammas.cpu().numpy())

    results = {
        "params_inits": res.params_inits,
        "params_optims": res.params_optims,
        "params_default": spec.defaults_flat[spec.opt_indices].cpu().numpy(),
        "params_name": np.asarray(spec.opt_keys, dtype="S"),
        "nll_optims": res.nll_optims,
        "num_lbfgs_iters": res.num_lbfgs_iters,
        "num_nll_evals": res.num_nll_evals,
        # each dispatch evaluates value and gradient together; counters coincide
        "num_nll_jac_evals": res.num_nll_evals,
        "gammas": res.gammas,
        "wall_clock_s": np.asarray(wall),
    }
    store_data(results, cfg["output"], mode="a")
    final_nll = np.asarray(results["nll_optims"][:, -1], np.float64)
    # diverged restarts leave NaN rows; pick the best finite one
    best = int(np.nanargmin(np.where(np.isfinite(final_nll), final_nll, np.inf)))
    print(
        f"optimize: {p0.shape[0]} restarts x {len(gammas)} stages in {wall:.1f}s ({route}, {mode} L-BFGS, {device}); "
        f"best NLL {results['nll_optims'][best, -1]:.3f} at "
        f"{results['params_optims'][best, -1]} -> {cfg['output']}",
        flush=True,
    )
    return {**results, "route": route, "optimizer_mode": mode, "units": units}


def evaluate(cfg) -> dict:
    """NLL landscape of ``cfg``; stores and returns the results."""
    rt = apply_runtime_config(cfg)
    dtype, device = rt["dtype"], rt["device"]
    rig = build_rig(cfg, dtype, device)
    nll_b, on_kernels = batched_nll(rig, cfg)
    route = "nll_fwd kernel" if on_kernels else "make_nll"
    gammas = gammas_of(cfg, dtype)
    spec = rig.spec

    evals = cfg["num_param_evals"]
    lo = spec.mins_flat[spec.opt_indices].cpu().numpy()
    hi = spec.maxs_flat[spec.opt_indices].cpu().numpy()
    axes = [np.linspace(0.0, 1.0, int(evals.get(k, 1))) for k in spec.opt_keys]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, len(axes))
    grid_t = torch.as_tensor(grid, dtype=dtype, device=device)

    batch_times: list = []
    landscape = make_nll_landscape(
        lambda p, q_sqrt, gamma_sqrt: nll_b(p, gamma_sqrt),
        rig.q_sqrt,
        batch_size=cfg.get("eval_batch", 256),
        timings_out=batch_times,
    )
    t0 = time.perf_counter()
    vals = landscape(grid_t, gammas).cpu().numpy()
    wall = time.perf_counter() - t0
    per_eval_ns = wall / max(vals.size, 1) * 1e9

    # Per-eval timings from the measured per-batch times: each grid point
    # carries its own batch's amortized ns (the first batch includes the
    # kernel build where one happens).
    timings = np.concatenate(
        [np.full(npts, sec / max(npts, 1) * 1e9) for npts, sec in batch_times]
    ) if batch_times else np.full(max(vals.size, 1), per_eval_ns)

    results = {
        "param_evals": grid * (hi - lo) + lo,
        "nll_evals": vals,
        "gammas": gammas.cpu().numpy(),
        "timings": timings[1:] if timings.size > 1 else timings,
    }
    store_data(results, cfg["output"], mode="a")
    print(
        f"evaluate: {vals.shape[1]} grid points x {vals.shape[0]} stages in {wall:.3f}s "
        f"({per_eval_ns:.0f} ns/eval amortized, {route}, {device}) -> {cfg['output']}",
        flush=True,
    )
    return {**results, "route": route, "wall_s": wall}


def main(argv=None) -> None:
    cfg = config_cli(
        "Tempered ODE parameter estimation (PyTorch/CUDA port)",
        positional=[("command", {"choices": ["optimize", "evaluate"]})],
        argv=argv,
    )
    (optimize if cfg["command"] == "optimize" else evaluate)(cfg)


if __name__ == "__main__":
    main()
