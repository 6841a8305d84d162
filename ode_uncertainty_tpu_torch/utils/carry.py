"""Carrying an experiment across from the JAX package.

The counterpart of carrying weights across: :func:`rig_from_numpy` takes the
values of a JAX estimation rig as numpy arrays (model parameters, the
parameter box, the initial state, the noise and observation arrays) and
builds the port's :class:`Rig` from them, so that both packages evaluate the
same NLL. :class:`Rig` is also what the port's entry point builds from a
config. :func:`lbfgs_state_from_numpy` does the same for the device
L-BFGS's state, so that a port segment resumes where a JAX segment stopped.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Union

import numpy as np
import torch

from ode_uncertainty_tpu_torch.filters.sqrt_ekf import EKFState, SqrtEKF
from ode_uncertainty_tpu_torch.inference.lbfgs import _State as LBFGSState
from ode_uncertainty_tpu_torch.inference.observations import ObsModel, compact_rows
from ode_uncertainty_tpu_torch.inference.params import ParamSpec
from ode_uncertainty_tpu_torch.models import (
    MODEL_REGISTRY,
    ODEModel,
    hodgkin_huxley,
    multi_compartment_hodgkin_huxley,
)
from ode_uncertainty_tpu_torch.solvers import TABLEAUS, ERK, Kvaerno3


@dataclasses.dataclass(frozen=True)
class Rig:
    """Everything the tempered NLL of one experiment is built from."""

    model: ODEModel
    solver: Union[ERK, Kvaerno3]
    ekf: SqrtEKF
    spec: ParamSpec
    obs: ObsModel
    state0: EKFState
    q_sqrt: torch.Tensor
    num_steps: int
    x0_raw: torch.Tensor


def _model_named(name: str) -> ODEModel:
    """The model whose ``ODEModel.name`` is ``name``, at its defaults."""
    hh = re.fullmatch(r"hodgkin_huxley_(full|reduced-1|reduced-4)(?:_x(\d+))?", name)
    if hh and hh.group(2):
        return multi_compartment_hodgkin_huxley(hh.group(1), int(hh.group(2)))
    if hh:
        return hodgkin_huxley(hh.group(1))
    return {f().name: f for f in MODEL_REGISTRY.values()}[name]()


def rig_from_numpy(d: Dict, device="cuda", dtype=torch.float32) -> Rig:
    """Builds the port's rig from a JAX rig's values.

    Keys of ``d``:
      * ``model``: the model's name (``ODEModel.name``), ``params``: {name: value};
      * ``tableau`` (e.g. ``"rkf45"``, or ``"kvaerno3"`` with an optional
        ``newton_iters``, default 6), ``h``, ``num_steps``, ``t0``;
      * ``disable_cov_update``;
      * ParamSpec: ``spec_keys``, ``spec_shapes``, ``defaults``, ``mins``,
        ``maxs``, ``opt_mask`` (bool over the flat vector);
      * ``x0`` [N, D], ``P0_sqrt``, ``H``, ``R_sqrt``, ``q_sqrt``, ``ys``,
        ``flags``, ``index_map``.

    Observation rows are compacted as the port's ``make_obs_model`` does (the
    rows no step reads are dropped), which leaves every step's value as is.
    """
    t = lambda a, dt=dtype: torch.as_tensor(np.array(a), dtype=dt, device=device)
    model = dataclasses.replace(
        _model_named(d["model"]),
        params={k: torch.as_tensor(np.asarray(v, np.float64)) for k, v in d["params"].items()},
    )
    if d["tableau"] == "kvaerno3":
        solver = Kvaerno3(float(d["h"]), int(d.get("newton_iters", 6)))
    else:
        solver = ERK(TABLEAUS[d["tableau"]], float(d["h"]))
    ekf = SqrtEKF(disable_cov_update=bool(d["disable_cov_update"]))

    mask = np.asarray(d["opt_mask"], bool)
    keys = tuple(d["spec_keys"])
    shapes = tuple(tuple(s) for s in d["spec_shapes"])
    owners = [k for k, s in zip(keys, shapes) for _ in range(int(np.prod(s)) if s else 1)]
    spec = ParamSpec(
        keys=keys,
        shapes=shapes,
        defaults_flat=t(d["defaults"]),
        mins_flat=t(d["mins"]),
        maxs_flat=t(d["maxs"]),
        opt_indices=torch.as_tensor(np.nonzero(mask)[0], dtype=torch.int64, device=device),
        opt_keys=tuple(k for k, m in zip(owners, mask) if m),
    )

    ys, index_map = compact_rows(d["ys"], d["flags"], d["index_map"])
    obs = ObsModel(
        H=t(d["H"]),
        R_sqrt=t(d["R_sqrt"]),
        ys=t(ys),
        flags=torch.as_tensor(np.asarray(d["flags"], bool), device=device),
        index_map=torch.as_tensor(index_map, device=device),
    )
    x0 = t(d["x0"])
    state0 = ekf.init_state(float(d["t0"]), x0, t(d["P0_sqrt"]), obs.obs_dim)
    return Rig(
        model=model,
        solver=solver,
        ekf=ekf,
        spec=spec,
        obs=obs,
        state0=state0,
        q_sqrt=t(d["q_sqrt"]),
        num_steps=int(d["num_steps"]),
        x0_raw=x0,
    )


def lbfgs_state_from_numpy(d: Dict, device="cuda", dtype=torch.float64) -> LBFGSState:
    """The port's device L-BFGS state from a JAX ``lbfgs`` state batched with
    ``vmap`` (its fields as numpy arrays, lanes leading: ``x`` [B, P],
    ``s_hist`` / ``y_hist`` [B, m, P], ``rho`` [B, m], the counters and
    flags [B]). Floating fields take ``dtype``, counters int32, flags bool."""
    kinds = {"done": torch.bool, **{k: torch.int32 for k in ("head", "count", "iters", "n_fev", "stall")}}
    return LBFGSState(**{
        field: torch.as_tensor(np.array(d[field]), dtype=kinds.get(field, dtype), device=device)
        for field in LBFGSState._fields
    })
