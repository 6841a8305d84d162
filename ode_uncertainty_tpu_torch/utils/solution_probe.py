"""Times the probabilistic-solution entry points on the card, each filter
path with its CUDA graphs and eagerly, and on the host's CPU, and checks
that the three give the same float64 numbers; first the square-root EKF's
predict by its two linearization routes (forward and reverse mode).

    python ode_uncertainty_tpu_torch/utils/solution_probe.py [--steps 300]

Prints one JSON line per run (``ms_per_step``, after one warm-up run of the
same size) and per comparison (the largest gap of each output key relative
to that key's largest magnitude), then the nvidia-smi line. Needs a card.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from ode_uncertainty_tpu_torch import run_calibration, run_filter, run_ode_solver  # noqa: E402
from ode_uncertainty_tpu_torch.inference import calibrate, filter_run  # noqa: E402
from ode_uncertainty_tpu_torch.utils import scan  # noqa: E402
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment  # noqa: E402

OUT = ROOT / "chiprun_out"
LV = "ekf_trajectory/rkf45/lotkavolterra"
GT_NPZ = ROOT / "ode_uncertainty_tpu_torch" / "data" / "gt_lotkavolterra.npz"
# (label, entry point, experiment, overrides, runs with graphs)
PATHS = [
    ("sqrt_ekf lotkavolterra", run_filter, LV, {}, True),
    ("sqrt_ekf lcao", run_filter, "ekf_trajectory/rkf45/lcao", {}, True),
    *[(f"{name} lotkavolterra", run_filter, LV, {"filter_builder": {"class_path": path}}, True)
      for name, path in (("dense_ekf", "EKF"), ("ukf", "UKF"), ("sqrt_ukf", "UKF_SQRT"), ("gmm_sqrt_ekf", "GMM_EKF"))],
    ("particle lotkavolterra", run_filter, "pf_trajectory/rkf45/lotkavolterra", {}, False),
    ("calibration lotkavolterra", run_calibration, "calibration/rkf45/lotkavolterra", {"y_path": str(GT_NPZ)}, True),
    ("solve gt/lotkavolterra (Dopri65)", run_ode_solver, "gt/lotkavolterra", {"save_interval": 1}, False),
    ("solve noise_gt/lotkavolterra (Kvaerno3)", run_ode_solver, "noise_gt/lotkavolterra",
     {"save_interval": 1, "noise_var": 0.0}, False),
]


def use_graphs(on: bool) -> None:
    loop = scan.scan_plan if on else functools.partial(scan.scan_plan, graphs=False)
    filter_run.scan_plan = calibrate.scan_plan = loop


def timed(entry, experiment, over, steps, device, float64):
    raw = load_experiment(experiment)
    h = raw["solver_builder"]["init_args"]["step_size"]
    cfg = build_config(raw, {**over, "device": device, "float64": float64, "tN": raw["t0"] + steps * h,
                             "output": str(OUT / "solution_probe.npz")})
    entry.run(cfg)  # warm-up (and the graphs' capture)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = entry.run(cfg)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in res.items()}, wall


def route_timing(device: str, steps: int = 50) -> dict:
    """ms per square-root EKF predict on Lotka-Volterra (float64, eagerly)
    by the two linearization routes: forward mode (autograd recording) and
    reverse mode (``filters/sqrt_ekf.py`` ``linearized_step``)."""
    from ode_uncertainty_tpu_torch import models, solvers
    from ode_uncertainty_tpu_torch.filters import SqrtEKF
    from ode_uncertainty_tpu_torch.ops import const_diag

    model, ekf = models.lotka_volterra(), SqrtEKF()
    predict = ekf.make_predict(solvers.rkf45(0.01), model.rhs)
    x0 = torch.tensor([[1.0, 1.0]], dtype=torch.float64, device=device)
    zq = torch.zeros(2, 2, dtype=torch.float64, device=device)
    zg = torch.zeros((), dtype=torch.float64, device=device)
    out = {}
    for route, grad in (("forward", True), ("reverse", False)):
        with torch.set_grad_enabled(grad):
            state = ekf.init_state(0.0, x0, const_diag(2, 1e-12, torch.float64, device), 2)
            state = predict(state, model.params, zq, zg)  # warm-up
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                state = predict(state, model.params, zq, zg)
            if device == "cuda":
                torch.cuda.synchronize()
        out[route] = (time.perf_counter() - t0) / steps * 1e3
    return out


def gap(a: dict, b: dict) -> dict:
    out = {}
    for k in a:
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        largest = np.nanmax(np.abs(y)) if y.size else 0.0
        out[k] = float(np.nanmax(np.abs(x - y)) / largest) if largest > 0 else float(np.nanmax(np.abs(x - y)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("solution_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    OUT.mkdir(exist_ok=True)
    for device in ("cuda", "cpu"):
        print(json.dumps({"path": "sqrt_ekf predict, lotkavolterra, eager", "device": device,
                          "ms_per_step_by_linearization_route": route_timing(device)}), flush=True)
    for label, entry, experiment, over, graphed in PATHS:
        runs = {}
        for device, graphs in (("cuda", True), ("cuda", False), ("cpu", False)):
            if graphs and not graphed:
                continue
            use_graphs(graphs)
            res, wall = timed(entry, experiment, over, ns.steps, device, True)
            runs[(device, graphs)] = res
            print(json.dumps({"path": label, "device": device, "cuda_graphs": graphs, "float64": True,
                              "steps": ns.steps, "ms_per_step": wall / ns.steps * 1e3}), flush=True)
        first = runs[("cuda", graphed)]
        print(json.dumps({"path": label, "gap_rel_to_largest": {
            "card_graphs_vs_card_eager": gap(first, runs[("cuda", False)]) if graphed else None,
            "card_vs_cpu": gap(first, runs[("cpu", False)])}}), flush=True)
    use_graphs(True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
