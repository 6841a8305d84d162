"""The gradient of the Kvaerno3 plain version of the NLL kernels
(``nll_grad_plain``, the port's route on the CPU and the oracle of the n = 7
gradient kernel) on Hodgkin-Huxley reduced-1 (n = 7), with the six
parameters of params/hodgkinhuxley6_r1 optimized, against central
differences of the JAX package's float64 XLA ``make_nll``.

The onset rig and limits of tests/test_torch_hh_grad_full.py (t0 = 9.9,
here 20 steps, ``accumulate_time``; step 1e-5, lane-normalized error
<= 1e-6; values rtol 1e-9). jax.grad of make_nll does not fit here either:
its compile ran over 9 minutes on one CPU core at n = 7 without finishing.
About 80 s on one CPU core, 130 s beside other busy cores.
"""

import pytest

from test_torch_hh_grad_full import check_fd, fd_case

OPTIMIZED = ("g_Na", "g_K", "g_leak", "V_T", "g_M", "g_L")  # params/hodgkinhuxley6_r1


@pytest.mark.parametrize("gamma_sqrt", [0.1, 0.0])
def test_grad_plain_matches_jax_make_nll_differences_r1(gamma_sqrt):
    check_fd(*fd_case("reduced-1", OPTIMIZED, gamma_sqrt, steps=20))
