"""Optimizer-quality parity: the port's L-BFGS optimizers against scipy's
L-BFGS-B (counterpart of ``scripts/compare_optimizer.py``).

On the same objective and the same random restarts it reports, per
optimizer, the restart hit rate (the share of restarts whose final-stage
NLL lands within ``hit_tol`` of the best of all methods), the best and
median final NLL, the best restart's largest parameter error against the
generating parameters (normalized box), the mean NLL evaluations per
restart and the wall seconds:

  scipy   scipy.optimize.minimize(method="L-BFGS-B") per restart per stage,
          driving the single-lane value and gradient;
  host    inference/lbfgs_host.py (batched, host-driven loop);
  device  inference/lbfgs.py through inference/estimate.py's stage
          optimizer (batched, on the device).

The objective is the entry points' (``run_parameter_estimation.batched_nll``):
the float64 NLL kernels where they cover the experiment, else ``make_nll``
and autograd. The reference pins the CPU because scipy needs float64 and a
TPU has none; the card has float64, so this runs on ``cuda`` by default,
in float64 (checked), and on the CPU with ``--set device=cpu``.

Usage:
  python -m ode_uncertainty_tpu_torch.compare_optimizer --experiment params/lotkavolterra2 \\
      [--restarts 64] [--maxiter 200] [--hit-tol 1.0] [--markdown] [--skip scipy,host,device] \\
      [--set device=cpu] [--set tN=0.5]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ode_uncertainty_tpu_torch.inference import make_stage_optimizer_host
from ode_uncertainty_tpu_torch.inference.estimate import make_stage_optimizer
from ode_uncertainty_tpu_torch.inference.lbfgs import value_and_grad
from ode_uncertainty_tpu_torch.run_parameter_estimation import batched_nll, build_rig, gammas_of, initial_restarts
from ode_uncertainty_tpu_torch.utils.config import apply_runtime_config, build_config, load_experiment, parse_set_value

HEADER = ("method", "hit_rate", "best_nll", "median_nll", "best_param_err", "mean_nll_evals", "wall_s")


def run_scipy(vg_single, p0, gammas, maxiter):
    """Per-restart, per-stage scipy L-BFGS-B (the reference's loop)."""
    from scipy.optimize import minimize

    r, p_dim = p0.shape
    out = np.empty_like(p0)
    fvals = np.empty(r)
    nfev = np.zeros(r, np.int64)
    for i in range(r):
        x = p0[i].copy()
        for g in gammas:
            res = minimize(
                lambda q, gg=g: vg_single(q, gg),
                x,
                jac=True,
                method="L-BFGS-B",
                bounds=[(0.0, 1.0)] * p_dim,
                options={"maxiter": maxiter},
            )
            x = np.clip(res.x, 0.0, 1.0)
            nfev[i] += res.nfev
        out[i] = x
        fvals[i] = res.fun
    return out, fvals, nfev


def compare(cfg, maxiter: int, skip=(), hit_tol: float = 1.0, p0=None) -> dict:
    """Runs each optimizer not in ``skip`` from the restarts ``p0`` (default:
    the config's, ``initial_restarts``). Returns ``{"rows": [...], "results":
    {method: (x, f, nfev, wall)}, "gammas", "p0", "device"}``."""
    rt = apply_runtime_config(cfg)
    dtype, device = rt["dtype"], rt["device"]
    if dtype != torch.float64:
        raise ValueError("the comparison runs in float64 (scipy's L-BFGS-B works in float64)")
    rig = build_rig(cfg, dtype, device)
    spec = rig.spec
    nll_b, _ = batched_nll(rig, cfg, grad=True)
    gammas = gammas_of(cfg, dtype).cpu().numpy()
    p0 = np.asarray(initial_restarts(cfg, spec, dtype).cpu() if p0 is None else p0, np.float64)
    restarts = len(p0)

    def vg_single(q, g):
        gs = torch.sqrt(torch.as_tensor(g, dtype=dtype))
        f, grad = value_and_grad(lambda p: nll_b(p, gs), torch.as_tensor(q, dtype=dtype, device=device)[None])
        return float(f[0]), grad[0].cpu().numpy()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    results = {}
    if "scipy" not in skip:
        t0 = time.perf_counter()
        x, f, nfev = run_scipy(vg_single, p0, gammas, maxiter)
        results["scipy L-BFGS-B"] = (x, f, nfev, time.perf_counter() - t0)

    if "host" not in skip:
        stage = make_stage_optimizer_host(None, rig.q_sqrt, nll_batched=nll_b, max_iter=maxiter, tol=1e-6)
        t0 = time.perf_counter()
        x = p0.copy()
        nfev = np.zeros(restarts, np.int64)
        for g in gammas:
            res = stage(torch.as_tensor(x, dtype=dtype, device=device), g)
            x = res.x
            nfev += res.n_fev
        results["host L-BFGS (ours)"] = (x, res.f, nfev, time.perf_counter() - t0)

    if "device" not in skip:
        stage = make_stage_optimizer(nll_b, max_iter=maxiter, tol=1e-6)
        t0 = time.perf_counter()
        x = torch.as_tensor(p0, dtype=dtype, device=device)
        nfev = np.zeros(restarts, np.int64)
        for g in gammas:
            res = stage(x, torch.as_tensor(g, dtype=dtype))
            x = res.x
            nfev += res.n_fev.cpu().numpy()
        sync()
        results["device L-BFGS (ours)"] = (x.cpu().numpy().astype(np.float64), res.f.cpu().numpy().astype(np.float64),
                                           nfev, time.perf_counter() - t0)

    # the generating parameters in normalized coordinates, for the recovery error
    truth_norm = spec.defaults_norm_opt().cpu().numpy().astype(np.float64)
    best_f_global = min(np.min(f) for _, f, _, _ in results.values())
    rows = []
    for name, (x, f, nfev, wall) in results.items():
        hit = float(np.mean(f <= best_f_global + hit_tol))
        b = int(np.argmin(f))
        perr = float(np.max(np.abs(x[b] - truth_norm)))
        rows.append((name, hit, float(np.min(f)), float(np.median(f)), perr, float(np.mean(nfev)), wall))
    return {"rows": rows, "results": results, "gammas": gammas, "p0": p0, "device": str(device)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Optimizer-quality parity against scipy L-BFGS-B (PyTorch/CUDA port)")
    ap.add_argument("--experiment", default="params/lotkavolterra2")
    ap.add_argument("--restarts", type=int, default=64)
    ap.add_argument("--maxiter", type=int, default=200)
    ap.add_argument("--hit-tol", type=float, default=1.0, help="NLL units above best that count as a hit")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--skip", default="", help="comma list of methods to skip")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a config key (e.g. device=cpu, tN=0.5)")
    args = ap.parse_args(argv)

    overrides = {"float64": True, "num_random_runs": args.restarts}
    for item in args.set:
        key, _, val = item.partition("=")
        overrides[key] = parse_set_value(val)
    cfg = build_config(load_experiment(args.experiment), overrides)
    out = compare(cfg, args.maxiter, set(args.skip.split(",")) if args.skip else set(), args.hit_tol)
    rows = out["rows"]
    print(f"device={out['device']} dtype=float64", flush=True)
    if args.markdown:
        print("| " + " | ".join(HEADER) + " |")
        print("|" + "---|" * len(HEADER))
        for r in rows:
            print(f"| {r[0]} | {r[1]:.2f} | {r[2]:.3f} | {r[3]:.3f} | {r[4]:.4f} | {r[5]:.0f} | {r[6]:.1f} |")
    else:
        print(f"{args.experiment}: {len(out['p0'])} restarts, {len(out['gammas'])} stages, hit_tol={args.hit_tol}")
        for r in rows:
            print(f"  {r[0]:<22} hit={r[1]:.2f} best={r[2]:.3f} med={r[3]:.3f} "
                  f"perr={r[4]:.4f} nfev={r[5]:.0f} wall={r[6]:.1f}s")
    return out


if __name__ == "__main__":
    main()
