"""Probes the estimation objective's route without a kernel (``make_nll`` +
autograd, eager) on the card.

    python ode_uncertainty_tpu_torch/utils/autograd_probe.py \\
        [--root CHECKOUT] [--parts steps,memory,dispatch,values] [--values-out FILE] \\
        [--experiment params/hodgkinhuxley2_c2_r4] [--steps 3] [--horizons 3,9]

Parts, each printing one JSON line per measurement, then the nvidia-smi
line:

  steps     seconds per step of the forward, the forward with autograd
            recording and the backward at 1 and at 100 lanes, float64 and
            float32 (after one warm-up call of the same size);
  memory    ``max_memory_allocated`` (MiB) of forward plus backward at 100
            lanes at each of ``--horizons``, with one checkpoint per
            observation interval (``remat``) and with none;
  dispatch  one value-and-gradient dispatch of ``optimize``'s objective
            (the experiment's 100 restarts, 3 steps, through the entry
            points' ``batched_nll``), float32 and float64, with gamma^1/2 a
            CPU scalar (as the host L-BFGS passes it) and on the card;
  values    ``make_nll``'s forward values (4 steps across the stimulus
            onset from t0 = 9.9, 8 lanes, float64 and float32, without and
            with autograd recording) saved to ``--values-out``, to compare
            two checkouts bit for bit.

``--root`` imports the package of another checkout (``values`` alone runs
on a checkout without this probe's other parts); the observations are this
checkout's npz copies. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
DATA = ROOT / "ode_uncertainty_tpu_torch" / "data"
OBSERVATIONS = {"params/hodgkinhuxley2_c2_r4": "hodgkinhuxley_c2_r4.npz",
                "params/hodgkinhuxley6_c2_r1": "hodgkinhuxley_c2_r1.npz",
                "params/hodgkinhuxley7_full": "hodgkinhuxley_full.npz"}


def _package():
    """The port's modules this probe calls (from the checkout on sys.path)."""
    from ode_uncertainty_tpu_torch import run_parameter_estimation as rpe
    from ode_uncertainty_tpu_torch.inference import make_nll
    from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment
    return rpe, make_nll, build_config, load_experiment


def rig_at(experiment: str, steps: int, dtype: torch.dtype, device: str = "cuda", t0: float = None):
    """(rig, config) of the experiment cut to ``steps`` steps (from ``t0`` if
    given), on its committed npz observations."""
    rpe, _, build_config, load_experiment = _package()
    raw = load_experiment(experiment)
    start = raw.get("t0", 0.0) if t0 is None else t0
    h = raw["solver_builder"]["init_args"]["step_size"]
    # tN half a step short of the last step: ceil((tN - t0) / h) is steps
    # whatever the rounding of t0 + steps * h
    over = {"device": device, "float64": dtype == torch.float64, "t0": start, "tN": start + (steps - 0.5) * h,
            "y_path": str(DATA / OBSERVATIONS[experiment]), "output": str(ROOT / "chiprun_out" / "probe.npz")}
    cfg = build_config(raw, over)
    return rpe.build_rig(cfg, dtype, device), cfg


def nll_of(rig, **kw):
    make_nll = _package()[1]
    return make_nll(rig.model, rig.solver, rig.ekf, rig.spec, rig.obs, rig.state0, rig.num_steps,
                    x0_raw=rig.x0_raw, **kw)


def points(rig, lanes: int, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(device=rig.q_sqrt.device).manual_seed(seed)
    return rig.spec.sample_norm(gen, lanes).to(rig.q_sqrt.dtype)


def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def step_times(rig, lanes: int, gamma_sqrt: float, reps: int = 2) -> dict:
    """Seconds per step of the forward without autograd, the forward
    recording and the backward, from the last of ``reps`` calls of each (the
    first warms up)."""
    nll = nll_of(rig)
    p = points(rig, lanes)
    g = torch.tensor(gamma_sqrt, dtype=p.dtype, device=p.device)
    out = {}
    for _ in range(reps):
        with torch.no_grad():
            _, fwd = synced(lambda: nll(p, rig.q_sqrt, g))
        q = p.clone().requires_grad_(True)
        v, rec = synced(lambda: nll(q, rig.q_sqrt, g))
        _, bwd = synced(lambda: v.sum().backward())
        out = {"fwd_s_per_step": fwd / rig.num_steps, "fwd_recording_s_per_step": rec / rig.num_steps,
               "bwd_s_per_step": bwd / rig.num_steps,
               "fwd_and_bwd_s_per_step": (rec + bwd) / rig.num_steps, "finite": bool(torch.isfinite(q.grad).all())}
    return out


def peak_memory(rig, lanes: int, gamma_sqrt: float, **kw) -> dict:
    """max_memory_allocated (MiB) of one forward plus backward, above what was
    allocated before it."""
    nll = nll_of(rig, **kw)
    q = points(rig, lanes).requires_grad_(True)
    g = torch.tensor(gamma_sqrt, dtype=q.dtype, device=q.device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (_, seconds) = synced(lambda: nll(q, rig.q_sqrt, g).sum().backward())
    return {"peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20, "seconds": seconds,
            "s_per_step": seconds / rig.num_steps}


def dispatch_times(experiment: str, steps: int = 3) -> list:
    """One value-and-gradient dispatch of optimize's objective on its first
    restarts, as the host L-BFGS makes it, three times per working type."""
    rpe = _package()[0]
    out = []
    for name in ("float32", "float64"):
        dtype = getattr(torch, name)
        rig, cfg = rig_at(experiment, steps, dtype)
        nll_b, on_kernels = rpe.batched_nll(rig, cfg, grad=True)
        p0 = rpe.initial_restarts(cfg, rig.spec, dtype)
        for where in ("cpu", "cuda", "cpu"):
            gs = torch.sqrt(torch.as_tensor(0.01, dtype=dtype)).to(where)
            p = p0.clone().requires_grad_(True)
            vals, fwd = synced(lambda: nll_b(p, gs))
            _, bwd = synced(lambda: torch.autograd.grad(vals, p, torch.ones_like(vals)))
            out.append({"dtype": name, "gamma_sqrt_on": where, "steps": rig.num_steps, "lanes": p.shape[0],
                        "on_kernels": on_kernels, "fwd_s": fwd, "bwd_s": bwd})
    return out


def forward_values(experiment: str) -> dict:
    """make_nll's forward values on a 4-step rig across the onset."""
    out = {}
    for name in ("float64", "float32"):
        dtype = getattr(torch, name)
        rig = rig_at(experiment, 4, dtype, t0=9.9)[0]
        nll = nll_of(rig)
        p = torch.as_tensor(np.random.default_rng(0).uniform(size=(8, rig.spec.num_opt)), dtype=dtype,
                            device="cuda")
        g = torch.tensor(0.1, dtype=dtype, device="cuda")
        with torch.no_grad():
            out[f"{name}_nograd"] = nll(p, rig.q_sqrt, g).cpu().numpy()
        out[f"{name}_recording"] = nll(p.clone().requires_grad_(True), rig.q_sqrt, g).detach().cpu().numpy()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--parts", default="steps,memory")
    ap.add_argument("--values-out", default=str(ROOT / "chiprun_out" / "autograd_probe_values.npz"))
    ap.add_argument("--experiment", default="params/hodgkinhuxley2_c2_r4")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--horizons", default="3,9")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("autograd_probe needs a card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    parts = args.parts.split(",")
    head = {"experiment": args.experiment, "root": str(Path(args.root).resolve()), "card": smi}
    gs = 0.1
    if "steps" in parts:
        for name in ("float64", "float32"):
            rig = rig_at(args.experiment, args.steps, getattr(torch, name))[0]
            for lanes in (1, 100):
                print(json.dumps({"probe": "step_times", **head, "dtype": name, "lanes": lanes, "steps": args.steps,
                                  "gamma_sqrt": gs, **step_times(rig, lanes, gs)}), flush=True)
    if "memory" in parts:
        for horizon in (int(h) for h in args.horizons.split(",")):
            rig = rig_at(args.experiment, horizon, torch.float64)[0]
            for label, kw in (("checkpoint per interval", {"remat": True}), ("none", {"chunk_size": 1})):
                print(json.dumps({"probe": "peak_memory", **head, "dtype": "float64", "lanes": 100,
                                  "steps": horizon, "checkpointing": label, **peak_memory(rig, 100, gs, **kw)}),
                      flush=True)
    if "dispatch" in parts:
        for line in dispatch_times(args.experiment):
            print(json.dumps({"probe": "dispatch", **head, **line}), flush=True)
    if "values" in parts:
        vals = forward_values(args.experiment)
        np.savez(args.values_out, **vals)
        print(json.dumps({"probe": "values", **head, "out": args.values_out,
                          **{k: v[:3].tolist() for k, v in vals.items()}}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
