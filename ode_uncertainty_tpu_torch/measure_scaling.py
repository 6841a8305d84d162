"""Weak-scaling curve of the restart-sharded estimation (counterpart of
``scripts/measure_scaling.py``): fixed restarts per shard, the number of
shards swept, each mesh built in this process. A line per shard count:
``{"path", "devices", "restarts", "wall_s", "partition_overhead", "cards",
"shards_per_card"}``, where ``partition_overhead`` is the wall time over
``devices`` times the one-shard time (1.0: the shards cost what they would
one after another; 1 / devices: perfect weak scaling).

``--path device`` shards the device L-BFGS's tempered estimator
(``parallel/mesh.make_sharded_tempered_estimator``, gammas 1e-2 and 1e-5);
``--path host`` shards every value-and-gradient dispatch of the host
L-BFGS (``inference/lbfgs_host.make_stage_optimizer_host(mesh=...)``, one
stage at gamma 1e-2). Both run 25 iterations (tol 0) of a small
Lotka-Volterra rig (40 RKF45 steps of 0.05, alpha and beta optimized,
float32) through the NLL kernels, warm once, and time the mean of 3 calls.

On the card the shards are laid round-robin over the visible cards, so on
one card a mesh of n shards puts n shards (each on a stream of its own) on
that card; ``cards`` names the distinct cards used. ``--device cpu`` lays
the shards on the CPU (the kernels' plain versions), where they run one
after another: that measures the sharding's overhead, not a speed-up.

Usage: python -m ode_uncertainty_tpu_torch.measure_scaling [--per-device 16]
           [--devices 1,2,4,8] [--path device|host] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ode_uncertainty_tpu_torch import models, solvers
from ode_uncertainty_tpu_torch.filters import SqrtEKF
from ode_uncertainty_tpu_torch.inference import make_obs_model, make_param_spec, make_stage_optimizer_host
from ode_uncertainty_tpu_torch.ops import const_diag
from ode_uncertainty_tpu_torch.ops.nll_kernel import make_nll_cuda
from ode_uncertainty_tpu_torch.parallel import device_mesh, make_sharded_tempered_estimator

H, NUM_STEPS = 0.05, 40
MAX_ITER = 25  # iterations a stage (tol 0: every lane runs them all)
REPS = 3  # timed calls after the warm one


def lv_rig(dtype=torch.float32):
    """``(spec, nll_on)``: the small Lotka-Volterra rig (counterpart of
    ``__graft_entry__._lv_rig``; observations of both states every 10 steps
    from the solve at the default parameters) and the factory of its
    objective on a device, the NLL kernels' wrapper."""
    m = models.lotka_volterra()
    sol = solvers.rkf45(step_size=H)
    x0 = torch.tensor([[1.0, 1.0]], dtype=dtype)
    gt = solvers.solve(sol, m, 0.0, x0, NUM_STEPS)
    idx = np.arange(10, NUM_STEPS + 1, 10)
    ys = gt["x"].numpy()[idx].reshape(len(idx), -1)
    t_obs = gt["t"].numpy()[idx]
    optimized = {"alpha": True, "beta": True, "gamma": False, "delta": False}
    box = {k: (0.1, 5.0) for k in m.params}

    def nll_on(device):
        obs = make_obs_model(np.eye(2), t_obs, ys, 0.01, 0.0, H, NUM_STEPS, dtype=dtype, device=device)
        spec = make_param_spec(m.params, box, optimized, dtype=dtype, device=device)
        ekf = SqrtEKF(disable_cov_update=True)
        state0 = ekf.init_state(0.0, x0.to(device), const_diag(2, 1e-6, dtype, device), 2)
        kern = make_nll_cuda(m, sol, ekf, spec, obs, state0, NUM_STEPS, torch.eye(2, dtype=dtype, device=device),
                             accumulate_time=True)
        return lambda p, q_sqrt, gamma_sqrt: kern(p, gamma_sqrt)

    return make_param_spec(m.params, box, optimized, dtype=dtype, device="cpu"), nll_on


def shard_devices(n: int, device: str) -> list:
    """n shards round-robin over the visible cards, or n on the CPU."""
    if device == "cpu":
        return [torch.device("cpu")] * n
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible (pass --device cpu to run on the CPU)")
    return [torch.device(f"cuda:{k % torch.cuda.device_count()}") for k in range(n)]


def measure(n: int, per: int, path: str, device: str) -> dict:
    """Mean wall seconds of REPS calls after a warm one, on n shards."""
    spec, nll_on = lv_rig()
    mesh = device_mesh(devices=shard_devices(n, device))
    p0 = spec.sample_norm(torch.Generator().manual_seed(0), per * n)
    q = torch.eye(2)
    if path == "device":
        est = make_sharded_tempered_estimator(nll_on, spec, q, mesh, max_iter=MAX_ITER, tol=0.0)
        gammas = torch.tensor([1e-2, 1e-5])
        run = lambda: est(p0, gammas).nll_optims
    else:
        stage = make_stage_optimizer_host(nll_on, q, max_iter=MAX_ITER, tol=0.0, mesh=mesh, progress_every=0)
        x0 = p0.numpy()
        run = lambda: stage(x0, 1e-2).f
    first = run()
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = run()
    wall = (time.perf_counter() - t0) / REPS
    cards = [f"{dev} {torch.cuda.get_device_name(dev)}" if dev.type == "cuda" else str(dev) for dev in mesh.distinct]
    return {"wall_s": wall, "cards": cards, "shards_per_card": n / len(cards),
            "finite": bool(np.isfinite(first).all() and np.isfinite(out).all())}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="Weak scaling of the restart-sharded estimation (PyTorch/CUDA port)")
    ap.add_argument("--per-device", type=int, default=16)
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--path", default="device", choices=["device", "host"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    rows = []
    base = None
    for n in [int(x) for x in args.devices.split(",")]:
        m = measure(n, args.per_device, args.path, args.device)
        base = base if base is not None else m["wall_s"]
        row = {"path": args.path, "devices": n, "restarts": n * args.per_device, "wall_s": m["wall_s"],
               "partition_overhead": m["wall_s"] / (n * base), "cards": m["cards"],
               "shards_per_card": m["shards_per_card"], "finite": m["finite"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
