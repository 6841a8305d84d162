"""Numerical ops: square-root linear algebra, the rank-1 Cholesky update,
linearization, observation alignment, normalization. The NLL kernel lives in
``ops.nll_kernel``."""

from ode_uncertainty_tpu_torch.ops.align import build_observation_maps, isin_tolerance, sync_times
from ode_uncertainty_tpu_torch.ops.chol_update import chol_update
from ode_uncertainty_tpu_torch.ops.linearize import pull_sqrt, push_sqrt, value_and_jacfwd
from ode_uncertainty_tpu_torch.ops.normalize import clip01, inv_normalize, normalize
from ode_uncertainty_tpu_torch.ops.sqrt_linalg import (
    cho_solve_sqrt,
    const_diag,
    jeffrey_gaussian_sqrt,
    kl_gaussian_sqrt,
    nll_gaussian_sqrt,
    pdf_gaussian_sqrt,
    sqrt_sum,
    tria,
)

__all__ = [
    "build_observation_maps",
    "chol_update",
    "isin_tolerance",
    "sync_times",
    "pull_sqrt",
    "push_sqrt",
    "value_and_jacfwd",
    "clip01",
    "inv_normalize",
    "normalize",
    "cho_solve_sqrt",
    "const_diag",
    "jeffrey_gaussian_sqrt",
    "kl_gaussian_sqrt",
    "nll_gaussian_sqrt",
    "pdf_gaussian_sqrt",
    "sqrt_sum",
    "tria",
]
