"""Parity of the Kvaerno3 plain version of the nll_fwd kernel with the JAX
package's ``make_nll_tiles`` on Hodgkin-Huxley full (n = 8), across the
stimulus onset: from t0 = 9.99 at the rest state, 2 steps, so the second
step starts at t = 10 (the tiles' time rule) with the stimulus on. Two
steps, float64 only: the JAX tile program, run eagerly, takes ~20 s a step
at n = 8 on one CPU core (compiled, it did not finish building in 20
minutes). Tolerance: float64 rtol 1e-9. Rigs from tests/test_torch_hh_nll.py.
"""

import numpy as np

from test_torch_hh_nll import TOL, tiles_vs_plain


def test_plain_version_matches_jax_tiles_across_the_onset_full():
    got, ref = tiles_vs_plain("full", "float64", 9.99, 2, 0.1)
    np.testing.assert_allclose(got, ref, **TOL["float64"])
