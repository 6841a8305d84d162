"""Observation/time-grid alignment (the port's own copy of
``ode_uncertainty_tpu/ops/align.py``; host numpy).

Precomputes which solver steps have an observation attached and the map
from step index to observation row, so the filter loop only does lookups.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def isin_tolerance(elements: np.ndarray, test_elements: np.ndarray, tol: float) -> np.ndarray:
    """Float-tolerant membership test for sorted 1-D arrays."""
    elements = np.asarray(elements)
    test_elements = np.asarray(test_elements)
    idx = np.searchsorted(test_elements, elements)

    right_oob = idx == len(test_elements)
    idx_r = np.where(right_oob, len(test_elements) - 1, idx)
    d_right = test_elements[idx_r] - elements
    d_right = np.where(right_oob, np.inf, d_right)

    left_oob = idx == 0
    idx_l = np.where(left_oob, 0, idx - 1)
    d_left = elements - test_elements[idx_l]
    d_left = np.where(left_oob, np.inf, d_left)

    return np.minimum(np.abs(d_left), np.abs(d_right)) <= tol


def sync_times(ts_x: np.ndarray, ts_y: np.ndarray, tol: float = 1e-8) -> Tuple[np.ndarray, np.ndarray]:
    """Matches solver times to observation times within tolerance.

    Returns (x_indices, y_indices): positions in ts_x that have a matching
    observation, and the corresponding positions in ts_y.
    """
    x_indices = np.nonzero(isin_tolerance(ts_x, ts_y, tol))[0]
    y_indices = np.nonzero(isin_tolerance(ts_y, np.asarray(ts_x)[x_indices], tol))[0]
    if len(x_indices) != len(y_indices):
        raise ValueError(
            f"Time-grid alignment mismatch: {len(x_indices)} solver times vs "
            f"{len(y_indices)} observation times within tol={tol}."
        )
    return x_indices, y_indices


def build_observation_maps(
    t0: float, step_size: float, num_steps: int, ts_y: np.ndarray, tol: float = 1e-8
) -> Tuple[np.ndarray, np.ndarray]:
    """Builds per-step (correct_flags [T] bool, obs_index_map [T] int32).

    Step k (k = 0..num_steps-1) lands at time t0 + (k+1)*h; flags mark steps
    with an observation, and the index map points into the observation rows.
    """
    ts_x = t0 + step_size * np.arange(1, num_steps + 1)
    x_idx, y_idx = sync_times(ts_x, ts_y, tol)
    flags = np.zeros(num_steps, dtype=bool)
    flags[x_idx] = True
    index_map = np.zeros(num_steps, dtype=np.int32)
    index_map[x_idx] = y_idx
    return flags, index_map
