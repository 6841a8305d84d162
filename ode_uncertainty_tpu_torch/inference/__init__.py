"""Inference layer: parameter box, observations, the tempered NLL and the
filter-free baseline NLL, the NLL landscape, the host L-BFGS and the device
L-BFGS with its tempered estimator and stage optimizer, the filter
trajectory drivers, the calibration sweep and the trajectory RMSE."""

from ode_uncertainty_tpu_torch.inference.calibrate import make_calibration
from ode_uncertainty_tpu_torch.inference.estimate import (
    EstimationResult,
    make_nll_landscape,
    make_tempered_estimator,
)
from ode_uncertainty_tpu_torch.inference.filter_run import (
    make_dense_run,
    make_ekf_run,
    make_ekf_run_static,
    make_gmm_run,
    make_pf_run,
)
from ode_uncertainty_tpu_torch.inference.lbfgs import LBFGSResult, lbfgs_box
from ode_uncertainty_tpu_torch.inference.lbfgs_host import (
    HostLBFGSResult,
    lbfgs_box_host,
    make_stage_optimizer_host,
)
from ode_uncertainty_tpu_torch.inference.nll import make_baseline_nll, make_nll
from ode_uncertainty_tpu_torch.inference.observations import (
    ObsModel,
    compact_rows,
    empty_obs_model,
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
from ode_uncertainty_tpu_torch.inference.trmse import make_trmse_evaluator, trmse

__all__ = [
    "EstimationResult",
    "LBFGSResult",
    "lbfgs_box",
    "make_tempered_estimator",
    "make_baseline_nll",
    "make_trmse_evaluator",
    "trmse",
    "make_calibration",
    "make_dense_run",
    "make_ekf_run",
    "make_ekf_run_static",
    "make_gmm_run",
    "make_pf_run",
    "HostLBFGSResult",
    "lbfgs_box_host",
    "make_stage_optimizer_host",
    "make_nll_landscape",
    "make_nll",
    "ObsModel",
    "compact_rows",
    "empty_obs_model",
    "make_obs_model",
    "ParamSpec",
    "make_param_spec",
    "SCHEDULE_REGISTRY",
    "CosineAnnealingSchedule",
    "ExponentialDecaySchedule",
    "LinearDecaySchedule",
    "NoiseSchedule",
]
