"""Min-max parameter normalization (port of ``ode_uncertainty_tpu/ops/normalize.py``;
optimizers work in [0, 1]^P). Operates leafwise on dicts of tensors."""

from __future__ import annotations

import torch


def normalize(values, mins, maxs):
    """Maps values into [0, 1] per key given min/max dicts."""
    return {k: (values[k] - mins[k]) / (maxs[k] - mins[k]) for k in values}


def inv_normalize(values, mins, maxs):
    """Inverse of :func:`normalize`."""
    return {k: values[k] * (maxs[k] - mins[k]) + mins[k] for k in values}


def clip01(values):
    """Projects a dict of tensors onto the unit box."""
    return {k: torch.clamp(v, 0.0, 1.0) for k, v in values.items()}
