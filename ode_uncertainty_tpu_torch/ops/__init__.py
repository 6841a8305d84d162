"""Numerical ops: square-root linear algebra, linearization, observation
alignment, normalization. The NLL kernel lives in ``ops.nll_kernel``."""

from ode_uncertainty_tpu_torch.ops.align import build_observation_maps, isin_tolerance, sync_times
from ode_uncertainty_tpu_torch.ops.linearize import push_sqrt
from ode_uncertainty_tpu_torch.ops.normalize import clip01, inv_normalize, normalize
from ode_uncertainty_tpu_torch.ops.sqrt_linalg import (
    cho_solve_sqrt,
    const_diag,
    nll_gaussian_sqrt,
    sqrt_sum,
)

__all__ = [
    "build_observation_maps",
    "isin_tolerance",
    "sync_times",
    "push_sqrt",
    "clip01",
    "inv_normalize",
    "normalize",
    "cho_solve_sqrt",
    "const_diag",
    "nll_gaussian_sqrt",
    "sqrt_sum",
]
