"""Inference layer: parameter box, observations, the tempered NLL, the NLL
landscape and the host L-BFGS. The on-device optimizer, calibration and
metrics are not ported yet."""

from ode_uncertainty_tpu_torch.inference.estimate import EstimationResult, make_nll_landscape
from ode_uncertainty_tpu_torch.inference.lbfgs_host import (
    HostLBFGSResult,
    lbfgs_box_host,
    make_stage_optimizer_host,
)
from ode_uncertainty_tpu_torch.inference.nll import make_nll
from ode_uncertainty_tpu_torch.inference.observations import (
    ObsModel,
    compact_rows,
    make_obs_model,
)
from ode_uncertainty_tpu_torch.inference.params import ParamSpec, make_param_spec
from ode_uncertainty_tpu_torch.inference.schedules import (
    SCHEDULE_REGISTRY,
    CosineAnnealingSchedule,
    ExponentialDecaySchedule,
    LinearDecaySchedule,
    NoiseSchedule,
)

__all__ = [
    "EstimationResult",
    "HostLBFGSResult",
    "lbfgs_box_host",
    "make_stage_optimizer_host",
    "make_nll_landscape",
    "make_nll",
    "ObsModel",
    "compact_rows",
    "make_obs_model",
    "ParamSpec",
    "make_param_spec",
    "SCHEDULE_REGISTRY",
    "CosineAnnealingSchedule",
    "ExponentialDecaySchedule",
    "LinearDecaySchedule",
    "NoiseSchedule",
]
