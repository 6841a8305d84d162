"""Tempered ODE parameter estimation entry point of the port (counterpart of
``scripts/run_parameter_estimation.py``). Subcommand:

  evaluate — NLL landscape over a parameter grid per tempering stage; writes
             ``param_evals``, ``nll_evals``, ``gammas`` and ``timings``.

The batched NLL goes through the CUDA kernel of ``ops/nll_kernel.py`` when
``supports()`` holds (its plain version on CPU tensors), else through the
port's ``make_nll``. ``optimize`` is not ported yet.

Usage:
  python -m ode_uncertainty_tpu_torch.run_parameter_estimation evaluate \\
      --experiment params/lotkavolterra2 [--set device=cpu] [--set tN=2] [--set output=out.h5]
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ode_uncertainty_tpu_torch.inference import make_nll, make_nll_landscape, make_obs_model, make_param_spec
from ode_uncertainty_tpu_torch.ops import const_diag
from ode_uncertainty_tpu_torch.ops.nll_kernel import make_nll_cuda, supports
from ode_uncertainty_tpu_torch.utils.carry import Rig
from ode_uncertainty_tpu_torch.utils.config import apply_runtime_config, config_cli, parse_literal
from ode_uncertainty_tpu_torch.utils.io import load_data, store_data


def num_steps_of(cfg, solver) -> int:
    return int(math.ceil((cfg["tN"] - cfg.get("t0", 0.0)) / solver.h))


def build_rig(cfg, dtype, device) -> Rig:
    """The experiment's model, solver, filter, parameter box, observations and
    initial state (counterpart of ``_build_rig`` and ``scripts/_common.py``)."""
    model = cfg["ode_builder"]
    solver = cfg["solver_builder"]
    ekf = cfg["filter_builder"]
    num_steps = num_steps_of(cfg, solver)
    x0_raw = torch.as_tensor(parse_literal(cfg["x0"]), dtype=dtype, device=device)
    x0 = model.build_initial_value(x0_raw, model.params).to(dtype)
    n = x0.numel()

    if cfg.get("y_path") is None or cfg.get("measurement_matrix") is None:
        raise ValueError("Estimation requires y_path and measurement_matrix")
    data = load_data(cfg["y_path"])
    obs = make_obs_model(
        np.asarray(parse_literal(cfg["measurement_matrix"]), dtype=float),
        np.asarray(data["t"]),
        np.asarray(data["x"]),
        cfg.get("obs_noise_var", 1e-3),
        cfg.get("t0", 0.0),
        solver.h,
        num_steps,
        dtype=dtype,
        device=device,
    )
    spec = make_param_spec(
        model.params, cfg["params_range"], cfg.get("params_optimized"), dtype=dtype, device=device
    )
    p0 = cfg.get("P0")
    p0_sqrt = (
        const_diag(n, 1e-12, dtype, device)
        if p0 is None
        else torch.linalg.cholesky(torch.as_tensor(parse_literal(p0), dtype=dtype, device=device))
    )
    state0 = ekf.init_state(cfg.get("t0", 0.0), x0, p0_sqrt, obs.obs_dim)
    # absent/null weights mean unmasked tempering noise
    w_raw = parse_literal(cfg.get("gamma_noise_weights"))
    w = torch.ones(n, dtype=dtype, device=device) if w_raw is None else torch.as_tensor(w_raw, dtype=dtype, device=device)
    return Rig(model, solver, ekf, spec, obs, state0, torch.diag(w), num_steps, x0_raw)


def batched_nll(rig: Rig, cfg):
    """``(nll(p [B, P_opt], q_sqrt, gamma_sqrt) -> [B], route)``: the NLL kernel
    when it covers the configuration, else the port's make_nll."""
    if supports(rig.model, rig.solver, rig.ekf, rig.obs):
        kernel = make_nll_cuda(
            rig.model, rig.solver, rig.ekf, rig.spec, rig.obs, rig.state0, rig.num_steps, rig.q_sqrt
        )
        return (lambda p, q_sqrt, gamma_sqrt: kernel(p, gamma_sqrt)), "nll_fwd kernel"
    nll = make_nll(
        rig.model,
        rig.solver,
        rig.ekf,
        rig.spec,
        rig.obs,
        rig.state0,
        rig.num_steps,
        x0_raw=rig.x0_raw,
        initial_state_parametrized=cfg.get("initial_state_parametrized", False),
        parameter_sensitivity=cfg.get("parameter_sensitivity", False),
    )
    return nll, "make_nll"


def gammas_of(cfg, dtype) -> torch.Tensor:
    sched = cfg["gamma_noise_schedule"]
    return sched.gammas(cfg.get("num_tempering_stages", 10), cfg.get("final_gamma_zero", True)).to(dtype)


def evaluate(cfg) -> dict:
    """NLL landscape of ``cfg``; stores and returns the results."""
    rt = apply_runtime_config(cfg)
    dtype, device = rt["dtype"], rt["device"]
    rig = build_rig(cfg, dtype, device)
    nll, route = batched_nll(rig, cfg)
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
        nll, rig.q_sqrt, batch_size=cfg.get("eval_batch", 256), timings_out=batch_times
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
        positional=[("command", {"choices": ["evaluate"]})],
        argv=argv,
    )
    evaluate(cfg)


if __name__ == "__main__":
    main()
