"""ODE solver layer: embedded explicit RK steppers (Kvaerno3 is not ported yet)."""

from ode_uncertainty_tpu_torch.solvers.erk import ERK, bs32, dopri65, heun_euler, rkf45
from ode_uncertainty_tpu_torch.solvers.solve import make_solve_fn, solve
from ode_uncertainty_tpu_torch.solvers.tableaus import (
    BS32,
    DOPRI65,
    HEUN_EULER,
    RKF45,
    TABLEAUS,
    ButcherTableau,
)

# Registry for config-driven instantiation.
SOLVER_REGISTRY = {
    "HeunEuler": heun_euler,
    "BS32": bs32,
    "RKF45": rkf45,
    "Dopri65": dopri65,
}

__all__ = [
    "ERK",
    "ButcherTableau",
    "heun_euler",
    "bs32",
    "rkf45",
    "dopri65",
    "make_solve_fn",
    "solve",
    "SOLVER_REGISTRY",
    "TABLEAUS",
    "HEUN_EULER",
    "BS32",
    "RKF45",
    "DOPRI65",
]
