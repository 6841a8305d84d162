"""Human-readable report of a parameter-estimation result (counterpart of
``scripts/report_estimation.py``). Host-only: it reads the result and the
experiment's config, and runs nothing on a device.

Prints, per tempering stage, the finite restarts, NLL quantiles and the
median L-BFGS iterations; then the best final-stage restart's estimates
against the generating values (the experiment's ode_builder defaults, the
convention of the tRMSE protocol), and the wall time. Array-valued
parameters (multi-compartment Hodgkin-Huxley) repeat their name once per
element in ``params_name``, in ravel order; a per-name cursor matches each
to its element.

Usage:
  python -m ode_uncertainty_tpu_torch.report_estimation --experiment params/hodgkinhuxley11_full \\
      [--set parameter_estimates_input=result.h5]
"""

from __future__ import annotations

import numpy as np

from ode_uncertainty_tpu_torch.utils.config import config_cli
from ode_uncertainty_tpu_torch.utils.io import load_data


def main(cfg) -> None:
    path = cfg.get("parameter_estimates_input") or cfg["output"]
    d = load_data(path)
    names = [n.decode() if isinstance(n, bytes) else str(n) for n in d["params_name"]]
    nll = np.asarray(d["nll_optims"])  # [runs, stages]
    params = np.asarray(d["params_optims"])  # [runs, stages, n_opt]
    runs, stages = nll.shape

    model = cfg["ode_builder"]
    true_flat = {k: np.ravel(np.asarray(v)) for k, v in model.params.items()}
    cursor: dict = {}

    print(f"{path}: {runs} restarts x {stages} stages, params: {', '.join(names)}")
    if "gammas" in d:
        print(f"  gammas: {np.asarray(d['gammas']).tolist()}")
    for s in range(stages):
        col = nll[:, s]
        ok = np.isfinite(col)
        q = np.nanquantile(col[ok], [0.1, 0.5, 0.9]) if ok.any() else [np.nan] * 3
        iters = np.asarray(d["num_lbfgs_iters"])[:, s] if "num_lbfgs_iters" in d else None
        extra = f"  iters med={int(np.median(iters))}" if iters is not None else ""
        print(
            f"  stage {s}: {int(ok.sum())}/{runs} finite, "
            f"nll q10/50/90 = {q[0]:.4g}/{q[1]:.4g}/{q[2]:.4g}{extra}"
        )

    final = nll[:, -1]
    if not np.isfinite(final).any():
        print("  no finite restart in the final stage")
        return
    best = int(np.nanargmin(final))
    print(f"  best restart: #{best}, final NLL {final[best]:.6g}")
    print(f"  {'param':>12} {'estimate':>14} {'truth':>14} {'rel err':>10}")
    for j, name in enumerate(names):
        est = float(params[best, -1, j])
        i = cursor.get(name, 0)
        cursor[name] = i + 1
        flat = true_flat.get(name)
        tru = float(flat[i]) if flat is not None and i < flat.size else np.nan
        rel = abs(est - tru) / max(abs(tru), 1e-12) if np.isfinite(tru) else np.nan
        label = name if flat is None or flat.size == 1 else f"{name}[{i}]"
        print(f"  {label:>12} {est:>14.6g} {tru:>14.6g} {rel:>9.2%}")
    if "wall_clock_s" in d:
        print(f"  wall_clock_s: {float(np.asarray(d['wall_clock_s'])):.1f}")


if __name__ == "__main__":
    main(config_cli("Report a parameter-estimation result (PyTorch/CUDA port)"))
