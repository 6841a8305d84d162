"""ODE model zoo (classic systems; the Hodgkin-Huxley family is not ported yet)."""

from ode_uncertainty_tpu_torch.models.base import ODEFn, ODEModel, Params, as_params, batch_param
from ode_uncertainty_tpu_torch.models.classic import (
    exponential,
    lcao,
    logistic,
    lorenz,
    lotka_volterra,
    pendulum,
    rlc_circuit,
    van_der_pol,
)

# Registry for config-driven instantiation (utils.config resolves these names).
MODEL_REGISTRY = {
    "Exponential": exponential,
    "Logistic": logistic,
    "LotkaVolterra": lotka_volterra,
    "Lorenz": lorenz,
    "Pendulum": pendulum,
    "VanDerPol": van_der_pol,
    "LCAO": lcao,
    "RLCCircuit": rlc_circuit,
}

__all__ = [
    "ODEFn",
    "ODEModel",
    "Params",
    "as_params",
    "batch_param",
    "exponential",
    "logistic",
    "lotka_volterra",
    "lorenz",
    "pendulum",
    "van_der_pol",
    "lcao",
    "rlc_circuit",
    "MODEL_REGISTRY",
]
