"""NLL landscape evaluation and the estimation result (port of
``make_nll_landscape`` and ``EstimationResult`` in
``ode_uncertainty_tpu/inference/estimate.py``). The tempered estimator and
its stage optimizer run on the host L-BFGS (``inference/lbfgs_host.py``);
the on-device ``make_stage_optimizer`` and ``make_tempered_estimator`` wait
for the on-device L-BFGS (``inference/lbfgs.py``), which is not ported yet."""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch


class EstimationResult(NamedTuple):
    """Result arrays (the H5 schema of the reference)."""

    params_inits: np.ndarray  # [R, P_opt] physical initial params
    params_optims: np.ndarray  # [R, S, P_opt] physical optima per stage
    nll_optims: np.ndarray  # [R, S]
    num_lbfgs_iters: np.ndarray  # [R, S]
    num_nll_evals: np.ndarray  # [R, S]
    gammas: np.ndarray  # [S]


def make_nll_landscape(
    nll: Callable,
    q_sqrt: torch.Tensor,
    batch_size: int = 256,
    timings_out: list | None = None,
):
    """NLL grid evaluation.

    ``nll(p_batch [B, P_opt], q_sqrt, gamma_sqrt) -> [B]`` is batched over the
    leading dim. Returns ``landscape(p_norm_grid [G, P_opt], gammas [S]) ->
    [S, G]``; the grid is evaluated in chunks of ``batch_size`` points.

    ``timings_out``: when a list is given, each batch is synchronized and
    timed, appending ``(points_in_batch, seconds)`` per batch (in stage-major
    order); leaving it ``None`` keeps the launches asynchronous.
    """

    def landscape(p_norm_grid: torch.Tensor, gammas) -> torch.Tensor:
        chunks = torch.split(p_norm_grid, batch_size)
        device = p_norm_grid.device
        rows = []
        for gamma in gammas:
            gamma_sqrt = torch.sqrt(torch.as_tensor(gamma, dtype=p_norm_grid.dtype))
            if timings_out is None:
                rows.append(torch.cat([nll(c, q_sqrt, gamma_sqrt) for c in chunks]))
                continue
            parts = []
            for c in chunks:
                t0 = time.perf_counter()
                v = nll(c, q_sqrt, gamma_sqrt)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                timings_out.append((c.shape[0], time.perf_counter() - t0))
                parts.append(v)
            rows.append(torch.cat(parts))
        return torch.stack(rows)

    return landscape
