"""Experiment-config system (port of ``ode_uncertainty_tpu/utils/config.py``
without its JAX runtime pins).

Configs are ``class_path``/``init_args`` object graphs plus flat script
kwargs. Class paths resolve by their last component against this package's
registries, so the shared experiment registry (``configs/experiments.py``,
which names the JAX package's classes) instantiates the port's objects.
``yaml`` is imported only to read a YAML file or parse a ``--set`` value;
without it, ``--set`` values are parsed as Python literals.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

REPO = Path(__file__).resolve().parents[2]
EXPERIMENTS = REPO / "configs" / "experiments.py"
# Config keys that hold paths; in the registry they are relative to configs/.
_PATH_KEYS = ("y_path", "output")


def _sqrt_ekf_adapter(
    cov_update_fn_builder=None,
    static_cov_update_fn_builder=None,
    disable_cov_update: bool = False,
    cov_update=None,
):
    """Accepts both this package's and the reference configs' ctor arg names.
    The static update builder is kept on the filter as ``static_cov_update``
    (``run_filter``'s ``use_static_cov_fn`` branch reads its scale)."""
    from ode_uncertainty_tpu_torch.filters import DiagonalUpdate, SqrtEKF

    cu = cov_update if cov_update is not None else cov_update_fn_builder
    ekf = SqrtEKF(cov_update=cu or DiagonalUpdate(), disable_cov_update=disable_cov_update)
    object.__setattr__(ekf, "static_cov_update", static_cov_update_fn_builder)
    return ekf


def _particle_filter_adapter(
    cov_update_fn_builder=None,
    static_cov_update_fn_builder=None,
    num_particles: int = 100,
    cov_update=None,
):
    """The particle filter under the reference configs' ctor arg names."""
    from ode_uncertainty_tpu_torch.filters import DiagonalUpdate, ParticleFilter

    cu = cov_update if cov_update is not None else cov_update_fn_builder
    pf = ParticleFilter(cov_update=cu or DiagonalUpdate(), num_particles=num_particles)
    object.__setattr__(pf, "static_cov_update", static_cov_update_fn_builder)
    return pf


def _hh_adapter(model: str = None, variant: str = "reduced-1", **kwargs):
    """Accepts the reference configs' ``model`` name for the variant."""
    from ode_uncertainty_tpu_torch.models import hodgkin_huxley

    return hodgkin_huxley(variant=model or variant, **kwargs)


def _mc_hh_adapter(model: str = None, variant: str = "reduced-1", **kwargs):
    """Multi-compartment HH; reference configs pass per-compartment vectors
    as stringified python lists."""
    from ode_uncertainty_tpu_torch.models import multi_compartment_hodgkin_huxley

    parsed = {k: parse_literal(v) if isinstance(v, str) else v for k, v in kwargs.items()}
    if "coupling_coeffs" in parsed and not isinstance(parsed["coupling_coeffs"], (list, tuple)):
        parsed["coupling_coeffs"] = [parsed["coupling_coeffs"]]
    return multi_compartment_hodgkin_huxley(variant=model or variant, **parsed)


def _registries() -> Dict[str, Callable]:
    from ode_uncertainty_tpu_torch.filters import COV_UPDATE_REGISTRY, FILTER_REGISTRY
    from ode_uncertainty_tpu_torch.inference.schedules import SCHEDULE_REGISTRY
    from ode_uncertainty_tpu_torch.models import MODEL_REGISTRY
    from ode_uncertainty_tpu_torch.solvers import SOLVER_REGISTRY

    merged: Dict[str, Callable] = {}
    for reg in (MODEL_REGISTRY, SOLVER_REGISTRY, FILTER_REGISTRY, COV_UPDATE_REGISTRY, SCHEDULE_REGISTRY):
        merged.update(reg)
    merged["SQRT_EKF"] = _sqrt_ekf_adapter
    merged["ParticleFilter"] = _particle_filter_adapter
    merged["HodgkinHuxley"] = _hh_adapter
    merged["MultiCompartmentHodgkinHuxley"] = _mc_hh_adapter
    merged.setdefault("DiffraxSolverBuilder", _diffrax_alias)
    return merged


def _diffrax_alias(name: str = "Kvaerno3", step_size: float = 0.1, **kw):
    """Maps the reference's diffrax wrapper config onto the port's solvers."""
    from ode_uncertainty_tpu_torch.solvers import SOLVER_REGISTRY

    if name not in SOLVER_REGISTRY:
        raise ValueError(
            f"No native equivalent for diffrax solver {name!r}; available: {sorted(SOLVER_REGISTRY)}"
        )
    return SOLVER_REGISTRY[name](step_size=step_size)


def resolve_class(class_path: str) -> Callable:
    """Resolves a class path by its final component against the registries."""
    name = class_path.rsplit(".", 1)[-1]
    reg = _registries()
    if name not in reg:
        raise KeyError(f"Unknown class {class_path!r} (known: {sorted(reg)})")
    return reg[name]


def instantiate(node: Any) -> Any:
    """Recursively instantiates class_path/init_args object graphs."""
    if isinstance(node, dict):
        if "class_path" in node:
            factory = resolve_class(node["class_path"])
            init_args = {k: instantiate(v) for k, v in node.get("init_args", {}).items()}
            return factory(**init_args)
        return {k: instantiate(v) for k, v in node.items()}
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node


def parse_literal(value: Optional[str]):
    """Parses stringified python literals (x0, matrices, weight vectors)."""
    if value is None:
        return None
    if isinstance(value, (list, tuple, float, int)):
        return value
    return ast.literal_eval(value)


def parse_set_value(text: str):
    """A ``--set`` value: YAML where ``yaml`` is installed, else a Python
    literal, else the string itself."""
    try:
        import yaml
    except ImportError:
        try:
            return ast.literal_eval(text)
        except (ValueError, SyntaxError):
            return {"null": None, "true": True, "false": False}.get(text, text)
    return yaml.safe_load(text)


def apply_runtime_config(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Reads the precision and device keys (``float64``, default False;
    ``device``, default ``"cuda"``) into ``{"dtype", "device"}`` and pins
    float32 matrix products and convolutions to full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {
        "dtype": torch.float64 if raw.get("float64", False) else torch.float32,
        "device": torch.device(raw.get("device") or "cuda"),
    }


def load_experiment(name: str) -> Dict[str, Any]:
    """The raw config of ``family/name`` from configs/experiments.py, with its
    relative paths resolved against the registry's directory."""
    spec = importlib.util.spec_from_file_location("_odeuq_experiments", EXPERIMENTS)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    raw = module.build(name)
    for key in _PATH_KEYS:
        value = raw.get(key)
        if isinstance(value, str) and not Path(value).is_absolute():
            raw[key] = str((EXPERIMENTS.parent / value).resolve())
    return raw


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Loads a YAML config into a kwargs dict with objects instantiated."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return build_config(raw, overrides)


def build_config(raw: Dict[str, Any], overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Applies overrides and instantiates every object node of a raw config."""
    raw = dict(raw)
    if overrides:
        raw.update({k: v for k, v in overrides.items() if v is not None})
    return {k: instantiate(v) for k, v in raw.items()}


def config_cli(
    description: str,
    extra_args: Optional[Dict[str, Any]] = None,
    positional: Optional[list] = None,
    argv: Optional[list] = None,
):
    """argparse front-end:
    ``(--config cfg.yaml | --experiment family/name) [--set k=v]``."""
    ap = argparse.ArgumentParser(description=description)
    for arg, kw in positional or []:
        ap.add_argument(arg, **kw)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--config", help="YAML config path")
    g.add_argument("--experiment", help="registry name, e.g. params/lotkavolterra2")
    ap.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="override a top-level config key (e.g. device=cpu, float64=true, output=out.h5)",
    )
    ns = ap.parse_args(argv)
    overrides = {}
    for item in ns.set:
        key, _, val = item.partition("=")
        overrides[key] = parse_set_value(val)

    if ns.config:
        cfg = load_config(ns.config, overrides)
    else:
        cfg = build_config(load_experiment(ns.experiment), overrides)
    for k, v in (extra_args or {}).items():
        cfg.setdefault(k, v)
    for arg, _ in positional or []:
        cfg[arg.lstrip("-")] = getattr(ns, arg.lstrip("-"))
    return cfg
