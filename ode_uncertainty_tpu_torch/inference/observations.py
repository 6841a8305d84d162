"""Observation model bundle for filtering and estimation (port of
``ode_uncertainty_tpu/inference/observations.py``).

Packs the measurement matrix, measurement noise, projected observations and
the per-step alignment arrays. The alignment is numpy on the host.

One difference in layout, none in values: the port keeps only the
observation rows that land on the step grid, so ``index_map`` counts them in
order. The JAX package keeps every row (an observation file's ``t = t0``
row included) and points into them. Each step reads the same observation
either way; with the compact layout the uniform-grid detection of
``ops/nll_kernel.py`` recognises the shipped observation files.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ode_uncertainty_tpu_torch.ops.align import build_observation_maps
from ode_uncertainty_tpu_torch.ops.sqrt_linalg import const_diag


@dataclasses.dataclass(frozen=True)
class ObsModel:
    """Observations aligned to the solver's step grid.

    Attributes:
        H: [L, n] measurement matrix (n = flat state size).
        R_sqrt: [L, L] observation-noise sqrt.
        ys: [T_obs, L] projected observations (H applied).
        flags: [num_steps] bool, step has an observation.
        index_map: [num_steps] int64, step -> observation row.
    """

    H: torch.Tensor
    R_sqrt: torch.Tensor
    ys: torch.Tensor
    flags: torch.Tensor
    index_map: torch.Tensor

    @property
    def obs_dim(self) -> int:
        return self.H.shape[0]


def compact_rows(ys: np.ndarray, flags: np.ndarray, index_map: np.ndarray):
    """Keeps the observation rows that some step reads, in step order, and
    renumbers ``index_map`` to match: ``(ys_used, index_map_compact)``."""
    flags = np.asarray(flags, bool)
    index_map = np.asarray(index_map)
    rows = index_map[flags]
    compact = np.zeros_like(index_map, dtype=np.int64)
    compact[flags] = np.arange(len(rows))
    return np.asarray(ys)[rows], compact


def make_obs_model(
    H,
    ts_y,
    ys_raw,
    obs_noise_var: float,
    t0: float,
    step_size: float,
    num_steps: int,
    dtype=torch.float32,
    tol: float = None,
    device="cuda",
) -> ObsModel:
    """Builds an :class:`ObsModel` from raw observation data.

    ys_raw: [T_obs, ...] raw states; projected through H after flattening
    trailing dims.

    The alignment tolerance defaults to a quarter of the finer of the two
    grids (solver step vs observation spacing), as in the JAX package.
    """
    h_mat = torch.as_tensor(np.asarray(H, np.float64), dtype=dtype)
    ys_flat = torch.as_tensor(np.asarray(ys_raw), dtype=dtype).reshape(len(ts_y), -1)
    ys = (ys_flat @ h_mat.T).numpy()
    if tol is None:
        ts_y64 = np.asarray(ts_y, np.float64)
        obs_spacing = np.min(np.diff(ts_y64)) if len(ts_y64) > 1 else np.inf
        tol = 0.25 * min(step_size, obs_spacing)
    flags, index_map = build_observation_maps(
        t0, step_size, num_steps, np.asarray(ts_y, np.float64), tol=tol
    )
    ys_used, index_map = compact_rows(ys, flags, index_map)
    return ObsModel(
        H=h_mat.to(device),
        R_sqrt=const_diag(h_mat.shape[0], obs_noise_var**0.5, dtype, device),
        ys=torch.as_tensor(ys_used, device=device),
        flags=torch.as_tensor(flags, device=device),
        index_map=torch.as_tensor(index_map, device=device),
    )


def empty_obs_model(n: int, num_steps: int, dtype=torch.float32, device="cuda") -> ObsModel:
    """Prediction-only mode: no observations, no corrections."""
    return ObsModel(
        H=torch.eye(n, dtype=dtype, device=device),
        R_sqrt=torch.zeros((n, n), dtype=dtype, device=device),
        ys=torch.zeros((1, n), dtype=dtype, device=device),
        flags=torch.zeros(num_steps, dtype=torch.bool, device=device),
        index_map=torch.zeros(num_steps, dtype=torch.int64, device=device),
    )
