"""Filter-free parameter estimation baseline of the port (counterpart of
``scripts/run_parameter_estimation_baseline.py``): integrate the ODE
deterministically and score the observations under fixed Gaussian noise
(``make_baseline_nll``), no filter and no tempering; one box L-BFGS per
restart, the restarts the lanes of the device L-BFGS (``lbfgs_box``) in
chunks of ``RESTART_CHUNK``. The gradient is autograd's through the eager
solve (through the Kvaerno3 stage-solve rule for the implicit step).
Subcommands:

  optimize — from ``num_random_runs`` restarts (a ``torch.Generator``
             seeded with ``seed``; 0 runs: the defaults); writes
             ``params_inits``, ``params_optims``, ``params_default``,
             ``params_name``, ``nll_optims``, ``num_lbfgs_iters``,
             ``num_nll_evals``, ``num_nll_jac_evals``, ``wall_clock_s``.
  evaluate — the NLL over the ``num_param_evals`` grid; writes
             ``param_evals``, ``nll_evals`` [1, G] and ``timings``.

Results go to the ``output`` path: H5, or ``.npz`` for a path with that
suffix.

Usage:
  python -m ode_uncertainty_tpu_torch.run_parameter_estimation_baseline optimize \\
      --experiment params_baseline/lotkavolterra2 [--set device=cpu] [--set output=out.npz]
  python -m ode_uncertainty_tpu_torch.run_parameter_estimation_baseline evaluate \\
      --experiment params_baseline/lotkavolterra2 [--set device=cpu] [--set eval_batch=256]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ode_uncertainty_tpu_torch._common import build_x0, load_observations, num_steps_of
from ode_uncertainty_tpu_torch.inference import lbfgs_box, make_baseline_nll, make_param_spec
from ode_uncertainty_tpu_torch.run_parameter_estimation import initial_restarts
from ode_uncertainty_tpu_torch.utils.config import apply_runtime_config, config_cli
from ode_uncertainty_tpu_torch.utils.io import store_data

# Restart batches beyond this are optimized in sequential chunks.
RESTART_CHUNK = 512


def build_baseline(cfg, dtype, device):
    """``(spec, nll)``: the experiment's parameter box and its baseline NLL
    ``nll(p_norm [B, P_opt]) -> [B]``."""
    model = cfg["ode_builder"]
    solver = cfg["solver_builder"]
    num_steps = num_steps_of(cfg, solver)
    x0_raw, x0 = build_x0(cfg, model, dtype, device)
    obs, has_obs = load_observations(cfg, solver, num_steps, x0.numel(), dtype, device)
    if not has_obs:
        raise ValueError("Estimation requires y_path and measurement_matrix")
    spec = make_param_spec(
        model.params, cfg["params_range"], cfg.get("params_optimized"), dtype=dtype, device=device
    )
    nll = make_baseline_nll(
        model,
        solver,
        spec,
        obs,
        cfg.get("t0", 0.0),
        x0,
        num_steps,
        x0_raw=x0_raw,
        initial_state_parametrized=cfg.get("initial_state_parametrized", False),
    )
    return spec, nll


def _synced(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def optimize(cfg) -> dict:
    """Baseline estimation of ``cfg``; stores and returns the results."""
    rt = apply_runtime_config(cfg)
    dtype, device = rt["dtype"], rt["device"]
    spec, nll = build_baseline(cfg, dtype, device)
    p0 = initial_restarts(cfg, spec, dtype)

    t0 = time.perf_counter()
    outs = [
        lbfgs_box(nll, p0[i : i + RESTART_CHUNK], 0.0, 1.0, max_iter=cfg.get("lbfgs_maxiter", 200),
                  tol=cfg.get("lbfgs_tol", 1e-4))
        for i in range(0, p0.shape[0], RESTART_CHUNK)
    ]
    _synced(device)
    wall = time.perf_counter() - t0
    cat = lambda f: torch.cat([getattr(o, f) for o in outs]).cpu().numpy()

    results = {
        "params_inits": spec.opt_to_physical(p0).cpu().numpy(),
        "params_optims": spec.opt_to_physical(torch.cat([o.x for o in outs])).cpu().numpy(),
        "params_default": spec.defaults_flat[spec.opt_indices].cpu().numpy(),
        "params_name": np.asarray(spec.opt_keys, dtype="S"),
        "nll_optims": cat("f"),
        "num_lbfgs_iters": cat("iters"),
        "num_nll_evals": cat("n_fev"),
        "num_nll_jac_evals": cat("n_fev"),
        "wall_clock_s": np.asarray(wall),
    }
    store_data(results, cfg["output"], mode="a")
    best = int(np.argmin(results["nll_optims"]))
    print(
        f"baseline optimize: {p0.shape[0]} restarts in {wall:.1f}s ({device}); best NLL "
        f"{results['nll_optims'][best]:.3f} at {results['params_optims'][best]} -> {cfg['output']}",
        flush=True,
    )
    return results


def evaluate(cfg) -> dict:
    """Baseline NLL over the ``num_param_evals`` grid; stores and returns
    the results."""
    rt = apply_runtime_config(cfg)
    dtype, device = rt["dtype"], rt["device"]
    spec, nll = build_baseline(cfg, dtype, device)
    evals = cfg["num_param_evals"]
    lo = spec.mins_flat[spec.opt_indices].cpu().numpy()
    hi = spec.maxs_flat[spec.opt_indices].cpu().numpy()
    axes = [np.linspace(0.0, 1.0, int(evals.get(k, 1))) for k in spec.opt_keys]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, len(axes))

    bs = cfg.get("eval_batch", 256)
    t0 = time.perf_counter()
    with torch.no_grad():
        vals = torch.cat(
            [nll(torch.as_tensor(grid[i : i + bs], dtype=dtype, device=device)) for i in range(0, len(grid), bs)]
        ).cpu().numpy()
    wall = time.perf_counter() - t0
    per_eval_ns = wall / max(vals.size, 1) * 1e9
    results = {
        "param_evals": grid * (hi - lo) + lo,
        "nll_evals": vals[None, :],
        "timings": np.full(max(vals.size - 1, 1), per_eval_ns),
    }
    store_data(results, cfg["output"], mode="a")
    print(f"baseline evaluate: {vals.size} evals in {wall:.1f}s ({device}) -> {cfg['output']}", flush=True)
    return {**results, "wall_s": wall}


def main(argv=None) -> None:
    cfg = config_cli(
        "Filter-free parameter estimation baseline (PyTorch/CUDA port)",
        positional=[("command", {"choices": ["optimize", "evaluate"]})],
        argv=argv,
    )
    (optimize if cfg["command"] == "optimize" else evaluate)(cfg)


if __name__ == "__main__":
    main()
