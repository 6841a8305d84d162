"""Checkpoint/resume and progress reporting for tempered estimation sweeps
(port of ``ode_uncertainty_tpu/utils/checkpoint.py``).

The (restart-chunk x tempering-stage) grid is the durable unit: after every
completed unit the full result store is written to a sidecar
``<output>.units.npz``, and a rerun skips the units it holds. Restart draws
are deterministic in the seed, so the sidecar holds results, not generator
state. Each unit prints its NLL quantiles, the median iteration count and an
ETA.
"""

from __future__ import annotations

import inspect
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch


def unit_sidecar(output: str) -> Path:
    return Path(str(output) + ".units.npz")


def run_stage_grid(
    output: str,
    p0,
    gammas,
    stage_fn: Callable,
    to_physical: Callable,
    chunk: int = 512,
    resume: bool = True,
    tag: str = "",
    log: Callable[[str], None] = print,
) -> dict:
    """Runs every (restart-chunk x stage) unit of a tempered estimation sweep
    with durable per-unit checkpointing.

    Args:
        p0: [R, P] normalized initial restarts (a tensor, or a numpy array);
            each unit's points go to ``stage_fn`` as a tensor of p0's dtype
            and device.
        gammas: [S] tempering noise levels.
        stage_fn: ``(p_norm [r, P], gamma[, unit_key]) -> result`` with fields
            ``x, f, iters, n_fev`` (a ``HostLBFGSResult``); runs one tempering
            stage for one restart chunk.
        to_physical: maps normalized [.., P] tensors to physical values.

    Returns a dict with the H5-schema result arrays
    (params_inits/params_optims/nll_optims/num_lbfgs_iters/num_nll_evals).
    """
    stage_takes_key = "unit_key" in inspect.signature(stage_fn).parameters
    p0_t = torch.as_tensor(p0)
    p0 = p0_t.detach().cpu().numpy()
    r, p_dim = p0.shape
    s = int(np.shape(gammas)[0])
    ck_path = unit_sidecar(output)

    def as_points(x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=p0_t.dtype, device=p0_t.device)

    def physical(x) -> np.ndarray:
        return to_physical(as_points(x)).detach().cpu().numpy()

    def fresh():
        return {
            # copy: p_current is updated in place per unit and must never
            # alias the caller's p0 (params_inits is derived from p0 at the end)
            "p_current": np.array(p0, np.float64),  # params after last done stage
            "stage_done": np.zeros((r, s), bool),
            "params_optims": np.full((r, s, p_dim), np.nan),
            "nll_optims": np.full((r, s), np.nan),
            "num_lbfgs_iters": np.zeros((r, s), np.int32),
            "num_nll_evals": np.zeros((r, s), np.int32),
        }

    store = fresh()
    if resume and ck_path.exists():
        with np.load(ck_path, allow_pickle=False) as z:
            if z["stage_done"].shape == (r, s):
                store = {k: z[k] for k in store}
                log(
                    f"[{tag}] resuming: "
                    f"{int(store['stage_done'].all(axis=1).sum())}/{r} restarts complete"
                )

    units = [
        (start, min(start + chunk, r), si)
        for start in range(0, r, chunk)
        for si in range(s)
    ]
    todo = [u for u in units if not store["stage_done"][u[0] : u[1], u[2]].all()]
    n_done_prior = len(units) - len(todo)
    unit_times: list[float] = []

    for k, (start, stop, si) in enumerate(todo):
        t0 = time.perf_counter()
        p_in = as_points(store["p_current"][start:stop])
        kw = {"unit_key": f"r{start}-{stop}-s{si}"} if stage_takes_key else {}
        print(
            f"[{tag}] starting unit {n_done_prior + k + 1}/{len(units)} "
            f"(restarts {start}:{stop}, stage {si + 1}/{s})",
            flush=True,
        )
        res = stage_fn(p_in, gammas[si], **kw)
        elapsed = time.perf_counter() - t0
        unit_times.append(elapsed)

        store["p_current"][start:stop] = np.asarray(res.x, np.float64)
        store["params_optims"][start:stop, si] = physical(res.x)
        store["nll_optims"][start:stop, si] = np.asarray(res.f)
        store["num_lbfgs_iters"][start:stop, si] = np.asarray(res.iters)
        store["num_nll_evals"][start:stop, si] = np.asarray(res.n_fev)
        store["stage_done"][start:stop, si] = True
        ck_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(ck_path, **store)

        f = store["nll_optims"][start:stop, si]
        finite = f[np.isfinite(f)]
        q = (
            np.percentile(finite, [10, 50, 90])
            if finite.size
            else np.full(3, np.nan)
        )
        # steady-state ETA: leave out the first unit (kernel build) when possible
        steady = unit_times[1:] if len(unit_times) > 1 else unit_times
        eta = float(np.mean(steady)) * (len(todo) - k - 1)
        log(
            f"[{tag}] unit {n_done_prior + k + 1}/{len(units)} "
            f"(restarts {start}:{stop}, stage {si + 1}/{s}, "
            f"gamma={float(gammas[si]):.3g}): {elapsed:.1f}s  "
            f"nll q10/50/90 = {q[0]:.3g}/{q[1]:.3g}/{q[2]:.3g}  "
            f"iters med={int(np.median(store['num_lbfgs_iters'][start:stop, si]))}  "
            f"ETA {eta / 60:.1f}m"
        )

    ck_path.unlink(missing_ok=True)
    return {
        "params_inits": physical(p0),
        "params_optims": store["params_optims"],
        "nll_optims": store["nll_optims"],
        "num_lbfgs_iters": store["num_lbfgs_iters"],
        "num_nll_evals": store["num_nll_evals"],
    }
