"""ODE model layer: RHS functions plus static metadata.

Port of ``ode_uncertainty_tpu/models/base.py``. A model is an immutable
descriptor holding ``rhs(t, y, params) -> dy/dt`` with ``y`` of shape
``[..., N, D]`` (ODE order N, latent dimension D, any leading batch dims).
Scalar parameters are tensors whose shape is the batch shape ``[...]`` (or
``[]`` for one shared value); :func:`batch_param` lines them up with a slice
of ``y``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

Params = Dict[str, torch.Tensor]
# rhs :: (t [], y [..., N, D], params) -> dy/dt [..., N, D]
ODEFn = Callable[[torch.Tensor, torch.Tensor, Params], torch.Tensor]


def _default_initial_value(x0: torch.Tensor, params: Params) -> torch.Tensor:
    del params
    return x0


def batch_param(params: Params, key: str, trailing: int = 1) -> torch.Tensor:
    """Parameter ``key`` with ``trailing`` unit axes appended, so a batch of
    scalars ``[...]`` broadcasts against a state slice ``[..., K]`` (or
    ``[..., N, D]`` with ``trailing=2``). A zero-dim value stays zero-dim: a
    zero-dim CPU tensor combines with tensors on any device."""
    value = params[key]
    return value if value.ndim == 0 else value[(...,) + (None,) * trailing]


@dataclasses.dataclass(frozen=True)
class ODEModel:
    """Immutable ODE descriptor (fields as in the JAX package's ``ODEModel``)."""

    name: str
    n_order: int
    dim: int
    rhs: ODEFn
    params: Params
    initial_value_fn: Callable[[torch.Tensor, Params], torch.Tensor] = _default_initial_value
    solution: Optional[Callable[[torch.Tensor, torch.Tensor, Params], torch.Tensor]] = None

    @property
    def state_shape(self) -> tuple:
        return (self.n_order, self.dim)

    @property
    def state_size(self) -> int:
        return self.n_order * self.dim

    def build_initial_value(self, x0: torch.Tensor, params: Optional[Params] = None) -> torch.Tensor:
        """Builds the full initial state from a (possibly partial) x0."""
        p = self.params if params is None else params
        return self.initial_value_fn(torch.as_tensor(x0), p)

    def with_params(self, **updates: float) -> "ODEModel":
        """Returns a copy with some default parameters replaced."""
        new = dict(self.params)
        for k, v in updates.items():
            if k not in new:
                raise KeyError(f"{self.name} has no parameter {k!r}")
            new[k] = torch.as_tensor(v, dtype=new[k].dtype)
        return dataclasses.replace(self, params=new)


def as_params(**kwargs) -> Params:
    """Converts python floats / lists to a parameter dict of float64 tensors
    on the CPU (zero-dim CPU tensors combine with tensors on any device)."""
    return {k: torch.as_tensor(v, dtype=torch.float64) for k, v in kwargs.items()}
