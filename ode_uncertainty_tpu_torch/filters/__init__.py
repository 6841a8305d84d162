"""Filter layer: the square-root EKF (the other filters are not ported yet)."""

from ode_uncertainty_tpu_torch.filters.cov_updates import (
    COV_UPDATE_REGISTRY,
    DiagonalUpdate,
    OuterUpdate,
)
from ode_uncertainty_tpu_torch.filters.sqrt_ekf import EKFState, SqrtEKF

FILTER_REGISTRY = {"SQRT_EKF": SqrtEKF}

__all__ = [
    "COV_UPDATE_REGISTRY",
    "DiagonalUpdate",
    "OuterUpdate",
    "EKFState",
    "SqrtEKF",
    "FILTER_REGISTRY",
]
