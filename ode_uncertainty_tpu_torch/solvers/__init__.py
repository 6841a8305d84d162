"""ODE solver layer: embedded explicit RK steppers and the Kvaerno3 ESDIRK stepper."""

from ode_uncertainty_tpu_torch.solvers.erk import ERK, bs32, dopri65, heun_euler, rkf45
from ode_uncertainty_tpu_torch.solvers.sdirk import Kvaerno3, kvaerno3
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
    "Kvaerno3": kvaerno3,
}

__all__ = [
    "ERK",
    "Kvaerno3",
    "ButcherTableau",
    "heun_euler",
    "bs32",
    "rkf45",
    "dopri65",
    "kvaerno3",
    "make_solve_fn",
    "solve",
    "SOLVER_REGISTRY",
    "TABLEAUS",
    "HEUN_EULER",
    "BS32",
    "RKF45",
    "DOPRI65",
]
