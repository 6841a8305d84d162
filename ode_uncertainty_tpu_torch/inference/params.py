"""Parameter-space specification for estimation (port of
``ode_uncertainty_tpu/inference/params.py``).

The optimizer works on a flat vector in [0, 1]^P over the *optimized*
parameter subset, scattered into the full default parameter vector at
evaluation time. All bookkeeping is precomputed on the host; evaluation is
one scatter plus elementwise affine ops over any leading batch dims.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

from ode_uncertainty_tpu_torch.models.base import Params


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Static description of the estimation parameter space.

    The flat layout follows sorted parameter names (as the JAX package's,
    so H5 outputs are comparable).
    """

    keys: Tuple[str, ...]  # sorted parameter names (full set)
    shapes: Tuple[Tuple[int, ...], ...]
    defaults_flat: torch.Tensor  # [P_full]
    mins_flat: torch.Tensor  # [P_full]
    maxs_flat: torch.Tensor  # [P_full]
    opt_indices: torch.Tensor  # [P_opt] int64 into the full flat vector
    opt_keys: Tuple[str, ...]  # names owning each optimized entry

    @property
    def num_full(self) -> int:
        return int(self.defaults_flat.shape[0])

    @property
    def num_opt(self) -> int:
        return int(self.opt_indices.shape[0])

    def unflatten(self, flat: torch.Tensor) -> Params:
        """[..., P_full] -> {name: [..., *shape]}."""
        out = {}
        pos = 0
        batch = flat.shape[:-1]
        for k, shp in zip(self.keys, self.shapes):
            size = int(np.prod(shp)) if shp else 1
            out[k] = flat[..., pos : pos + size].reshape(*batch, *shp)
            pos += size
        return out

    def flatten(self, params: Params) -> torch.Tensor:
        """{name: [..., *shape]} -> [..., P_full]."""
        parts = []
        for k, shp in zip(self.keys, self.shapes):
            v = torch.as_tensor(params[k])
            batch = v.shape[: v.ndim - len(shp)]
            parts.append(v.reshape(*batch, -1))
        batch = torch.broadcast_shapes(*[p.shape[:-1] for p in parts])
        return torch.cat([p.expand(*batch, p.shape[-1]) for p in parts], dim=-1)

    # --- optimized-subset (normalized) space --------------------------------
    def to_params(self, p_norm_opt: torch.Tensor) -> Params:
        """Maps normalized optimized vectors [..., P_opt] to a full param dict."""
        lo = self.mins_flat[self.opt_indices]
        hi = self.maxs_flat[self.opt_indices]
        vals = p_norm_opt * (hi - lo) + lo
        full = self.defaults_flat.expand(*vals.shape[:-1], self.num_full).clone()
        full[..., self.opt_indices] = vals.to(full.dtype)
        return self.unflatten(full)

    def opt_to_physical(self, p_norm_opt: torch.Tensor) -> torch.Tensor:
        """Normalized optimized vector -> physical values [..., P_opt]."""
        lo = self.mins_flat[self.opt_indices]
        hi = self.maxs_flat[self.opt_indices]
        return p_norm_opt * (hi - lo) + lo

    def physical_to_opt(self, p_phys: torch.Tensor) -> torch.Tensor:
        lo = self.mins_flat[self.opt_indices]
        hi = self.maxs_flat[self.opt_indices]
        return (p_phys - lo) / (hi - lo)

    def defaults_norm_opt(self) -> torch.Tensor:
        """Default values of the optimized subset, normalized."""
        return self.physical_to_opt(self.defaults_flat[self.opt_indices])

    def opt_mask_full(self) -> torch.Tensor:
        mask = torch.zeros(self.num_full, dtype=torch.bool, device=self.defaults_flat.device)
        mask[self.opt_indices] = True
        return mask

    def sample_norm(self, generator: torch.Generator, num: int) -> torch.Tensor:
        """Uniform restarts in the normalized box: [num, P_opt], drawn on the
        generator's device."""
        return torch.rand(
            (num, self.num_opt),
            generator=generator,
            dtype=self.defaults_flat.dtype,
            device=generator.device,
        ).to(self.defaults_flat.device)


def make_param_spec(
    defaults: Params,
    params_range: Mapping[str, Tuple[float, float]],
    params_optimized: Mapping[str, bool] | None = None,
    dtype=torch.float32,
    device="cuda",
) -> ParamSpec:
    """Builds a :class:`ParamSpec`.

    Args:
        defaults: model default parameter dict.
        params_range: per-name (min, max) bounds (required for every optimized name).
        params_optimized: per-name bool; missing names default to True.
    """
    keys = tuple(sorted(defaults.keys()))
    if params_optimized is None:
        params_optimized = {k: True for k in keys}
    shapes = []
    defaults_parts, mins_parts, maxs_parts = [], [], []
    opt_idx, opt_keys = [], []
    pos = 0
    for k in keys:
        v = np.asarray(torch.as_tensor(defaults[k]).cpu(), dtype=np.float64)
        shapes.append(tuple(v.shape))
        size = v.size
        lo, hi = params_range.get(k, (np.nan, np.nan))
        if params_optimized.get(k, True) and (np.isnan(lo) or np.isnan(hi)):
            raise ValueError(f"params_range missing for optimized parameter {k!r}")
        defaults_parts.append(v.ravel())
        mins_parts.append(np.full(size, lo))
        maxs_parts.append(np.full(size, hi))
        if params_optimized.get(k, True):
            opt_idx.extend(range(pos, pos + size))
            opt_keys.extend([k] * size)
        pos += size

    def tensor(parts):
        return torch.as_tensor(np.concatenate(parts), dtype=dtype, device=device)

    return ParamSpec(
        keys=keys,
        shapes=tuple(shapes),
        defaults_flat=tensor(defaults_parts),
        mins_flat=tensor(mins_parts),
        maxs_flat=tensor(maxs_parts),
        opt_indices=torch.as_tensor(np.asarray(opt_idx, np.int64), device=device),
        opt_keys=tuple(opt_keys),
    )
