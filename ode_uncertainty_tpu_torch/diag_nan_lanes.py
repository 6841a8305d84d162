"""Classify the diverged restarts of an estimation result (counterpart of
``scripts/diag_nan_lanes.py``).

For every restart whose final-stage NLL is not finite, it takes the stage
where the restart first went non-finite and re-evaluates the NLL (value
only) at the point that stage started from (the initial parameters for
stage 0, else the previous stage's optimum), at that stage's gamma, in
float32 and in float64, and prints a classification per lane:

  - f32 NaN / f64 finite  -> f32-numerics
  - f64 NaN               -> divergent-filter (param point)
  - both finite           -> finite-on-reeval (runtime/optimizer state)

The objective is the entry points' (``run_parameter_estimation.batched_nll``:
the NLL kernels where they cover the experiment) at ``gamma^1/2`` with the
experiment's ``q_sqrt``, which is what ``optimize`` evaluated at that stage.
The JAX script passes ``gamma`` itself where its objective takes
``gamma^1/2`` (its ``q_sqrt`` is I, as params/hodgkinhuxley11_full's noise
weights make it); the two agree at gamma = 0.

The default is params/hodgkinhuxley11_full and its committed result
``results/params/hodgkinhuxley11_full.h5`` (``output``); another result is
read from ``parameter_estimates_input`` (H5 or npz). It runs on ``cuda``
unless ``--set device=cpu``.

Usage:
  python -m ode_uncertainty_tpu_torch.diag_nan_lanes [--experiment params/hodgkinhuxley11_full] \\
      [--set parameter_estimates_input=result.npz] \\
      [--set y_path=ode_uncertainty_tpu_torch/data/hodgkinhuxley_full.npz] [--set device=cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ode_uncertainty_tpu_torch.run_parameter_estimation import batched_nll, build_rig
from ode_uncertainty_tpu_torch.utils.config import apply_runtime_config, config_cli
from ode_uncertainty_tpu_torch.utils.io import load_data

EXPERIMENT = "params/hodgkinhuxley11_full"


def build_nll(cfg, dtype):
    """``eval_batch(p_phys [B, P_opt], gamma) -> [B]`` (numpy float64): the
    entry points' NLL of ``cfg`` in ``dtype`` on the config's device, at
    ``gamma^1/2``, from physical optimized parameters."""
    device = apply_runtime_config(cfg)["device"]
    rig = build_rig(cfg, dtype, device)
    nll_b, _ = batched_nll(rig, cfg)

    def eval_batch(p_phys, gamma) -> np.ndarray:
        p_norm = rig.spec.physical_to_opt(torch.as_tensor(np.asarray(p_phys), dtype=dtype, device=device))
        with torch.no_grad():
            vals = nll_b(p_norm, torch.sqrt(torch.as_tensor(float(gamma), dtype=dtype)))
        return vals.cpu().numpy().astype(np.float64)

    return eval_batch


def nan_cases(d) -> list:
    """``(lane, stage, entry point, gamma)`` for every lane whose final-stage
    NLL is not finite: its first non-finite stage and that stage's start."""
    nll = np.asarray(d["nll_optims"])
    gammas = np.asarray(d["gammas"])
    inits, optims = np.asarray(d["params_inits"]), np.asarray(d["params_optims"])
    cases = []
    for i in np.nonzero(~np.isfinite(nll[:, -1]))[0]:
        s = int(np.argmax(~np.isfinite(nll[i])))
        entry = inits[i] if s == 0 else optims[i, s - 1]
        cases.append((int(i), s, entry, float(gammas[s])))
    return cases


def evaluate(eval_batch, cases) -> np.ndarray:
    """The NLL at every case's entry point and gamma, one evaluation per
    distinct gamma."""
    out = np.full(len(cases), np.nan)
    for gam in sorted({c[3] for c in cases}):
        idx = [k for k, c in enumerate(cases) if c[3] == gam]
        out[idx] = eval_batch(np.stack([cases[k][2] for k in idx]), gam)
    return out


def classify(v32: float, v64: float) -> str:
    if not np.isfinite(v32) and np.isfinite(v64):
        return "f32-numerics"
    if not np.isfinite(v64):
        return "divergent-filter (param point)"
    return "finite-on-reeval (runtime/optimizer state)"


def run(cfg) -> list:
    """Re-evaluates the non-finite lanes of the result ``cfg`` names; prints
    and returns one dict per lane (lane, stage, gamma, nll_f32, nll_f64,
    classification). Lanes of one stage gamma share one evaluation."""
    cases = nan_cases(load_data(cfg.get("parameter_estimates_input") or cfg["output"]))
    vals = {tag: evaluate(build_nll(cfg, dtype), cases) for tag, dtype in (("f32", torch.float32),
                                                                          ("f64", torch.float64))}

    rows = []
    print(f"{'lane':>5} {'stage':>5} {'gamma':>9} {'nll_f32':>14} {'nll_f64':>14}  classification")
    for k, (i, s, _, gam) in enumerate(cases):
        v32, v64 = float(vals["f32"][k]), float(vals["f64"][k])
        cls = classify(v32, v64)
        print(f"{i:>5} {s:>5} {gam:>9.4g} {v32:>14.6g} {v64:>14.6g}  {cls}")
        rows.append({"lane": i, "stage": s, "gamma": gam, "nll_f32": v32, "nll_f64": v64, "classification": cls})
    return rows


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--experiment" not in argv and "--config" not in argv:
        argv = ["--experiment", EXPERIMENT, *argv]
    return run(config_cli("Classify the diverged restarts of an estimation result (PyTorch/CUDA port)", argv=argv))


if __name__ == "__main__":
    main()
