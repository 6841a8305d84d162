"""IO, config, kernel build, carry-across and debugging utilities."""

from ode_uncertainty_tpu_torch.utils.config import config_cli, instantiate, load_config, parse_literal
from ode_uncertainty_tpu_torch.utils.debug import assert_finite, count_nonfinite
from ode_uncertainty_tpu_torch.utils.io import load_data, store_data
from ode_uncertainty_tpu_torch.utils.scan import scan_save

__all__ = [
    "assert_finite",
    "count_nonfinite",
    "config_cli",
    "instantiate",
    "load_config",
    "parse_literal",
    "load_data",
    "store_data",
    "scan_save",
]
