"""ODE model zoo: the classic systems and the Hodgkin-Huxley family."""

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
from ode_uncertainty_tpu_torch.models.hodgkin_huxley import (
    hodgkin_huxley,
    multi_compartment_hodgkin_huxley,
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
    "HodgkinHuxley": hodgkin_huxley,
    "MultiCompartmentHodgkinHuxley": multi_compartment_hodgkin_huxley,
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
    "hodgkin_huxley",
    "multi_compartment_hodgkin_huxley",
    "MODEL_REGISTRY",
]
