"""Restart sharding over several devices."""

from ode_uncertainty_tpu_torch.parallel.mesh import (
    RESTART_AXIS,
    Mesh,
    device_mesh,
    make_sharded_nll_landscape,
    make_sharded_tempered_estimator,
    make_sharded_value_and_grad,
    replicated,
    restart_sharding,
    shard_restarts,
)

__all__ = [
    "RESTART_AXIS",
    "Mesh",
    "device_mesh",
    "make_sharded_nll_landscape",
    "make_sharded_tempered_estimator",
    "make_sharded_value_and_grad",
    "replicated",
    "restart_sharding",
    "shard_restarts",
]
