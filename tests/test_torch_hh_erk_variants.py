"""The plain version of the NLL kernels on Hodgkin-Huxley reduced-1 (n = 7)
and full (n = 8) under RKF45, against the JAX package's ``make_nll_tiles``
(eagerly) on the onset rigs of tests/test_torch_hh_erk.py (t0 = 9.98, 4
steps, V observed). Tolerance: float64 rtol 1e-9.
"""

import pytest

from test_torch_hh_erk import check_values


@pytest.mark.parametrize("variant", ["reduced-1", "full"])
def test_plain_values_match_jax_tiles_across_the_onset(variant):
    check_values(variant, "rkf45")
