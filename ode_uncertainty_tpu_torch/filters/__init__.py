"""Filter layer: the square-root EKF, the particle filter and the extension
filters (dense EKF, UKF, square-root UKF, Gaussian-mixture sqrt-EKF)."""

from ode_uncertainty_tpu_torch.filters.cov_updates import (
    COV_UPDATE_REGISTRY,
    DiagonalUpdate,
    OuterUpdate,
    StaticDiagonalUpdate,
)
from ode_uncertainty_tpu_torch.filters.ekf import DenseEKF, DenseEKFState
from ode_uncertainty_tpu_torch.filters.gmm_ekf import GMMSqrtEKF, GMMState
from ode_uncertainty_tpu_torch.filters.particle import ParticleFilter, PFState
from ode_uncertainty_tpu_torch.filters.sqrt_ekf import EKFState, SqrtEKF
from ode_uncertainty_tpu_torch.filters.ukf import UKF, SqrtUKF

FILTER_REGISTRY = {
    "SQRT_EKF": SqrtEKF,
    "ParticleFilter": ParticleFilter,
    # extension filters (the reference's deprecated algorithm set)
    "EKF": DenseEKF,
    "UKF": UKF,
    "UKF_SQRT": SqrtUKF,
    "GMM_EKF": GMMSqrtEKF,
}

__all__ = [
    "COV_UPDATE_REGISTRY",
    "DiagonalUpdate",
    "OuterUpdate",
    "StaticDiagonalUpdate",
    "ParticleFilter",
    "PFState",
    "EKFState",
    "SqrtEKF",
    "DenseEKF",
    "DenseEKFState",
    "UKF",
    "SqrtUKF",
    "GMMSqrtEKF",
    "GMMState",
    "FILTER_REGISTRY",
]
