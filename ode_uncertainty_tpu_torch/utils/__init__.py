"""IO, config, kernel build and carry-across utilities."""

from ode_uncertainty_tpu_torch.utils.config import config_cli, instantiate, load_config, parse_literal
from ode_uncertainty_tpu_torch.utils.io import load_data, store_data
from ode_uncertainty_tpu_torch.utils.scan import scan_save

__all__ = [
    "config_cli",
    "instantiate",
    "load_config",
    "parse_literal",
    "load_data",
    "store_data",
    "scan_save",
]
