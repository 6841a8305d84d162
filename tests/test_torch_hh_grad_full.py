"""The gradient of the Kvaerno3 plain version of the NLL kernels
(``nll_grad_plain``, the port's route on the CPU and the oracle of the n = 8
gradient kernel) on Hodgkin-Huxley full (n = 8), with the seven parameters
of params/hodgkinhuxley7_full optimized, against central differences of
the JAX package's float64 XLA ``make_nll``.

The rig crosses the stimulus onset: t0 = 9.9 from the rest state, 16 steps,
V observed after each (the running sum switches the stimulus on at step 11,
counting from 0), with the XLA path's time rule (``accumulate_time``, the
rule of the entry points). jax.grad of make_nll takes minutes to compile
at n = 8 on one CPU core; the forward compiles in about a minute. So
d NLL / d p_norm and d NLL / d gamma^1/2 are held to central differences of
the forward with a step of 1e-5 in every normalized coordinate and in
gamma^1/2, at a lane-normalized error |port - differences| /
(|differences| + 1) <= 1e-6 (the step sits between the differences'
truncation error at larger steps and their rounding error at smaller
ones); the NLL values at float64 rtol 1e-9. The shared gradient code is
held to jax.grad at rtol 1e-9 on reduced-4 (tests/test_torch_hh_grad.py).
About 110 s on one CPU core, 130-160 s beside other busy cores. Rigs from
tests/test_torch_hh_nll.py.
"""

import numpy as np
import pytest

from test_torch_hh_grad import jax_central_differences, port_grads
from test_torch_hh_nll import TOL, hh_rigs

OPTIMIZED = ("g_Na", "g_K", "g_leak", "V_T", "g_M", "g_L", "g_T")  # params/hodgkinhuxley7_full
FD_STEP = 1e-5
FD_TOL = 1e-6


def fd_case(variant, optimized, gamma_sqrt, steps):
    """(port NLL, d/d p_norm, d/d gamma^1/2) and (JAX NLL, central
    differences) on 4 random normalized points of the onset rig."""
    jrig, trig = hh_rigs(variant, "float64", 9.9, steps, optimized=optimized)
    p = np.random.default_rng(1).uniform(size=(4, len(optimized)))
    vals, fd = jax_central_differences(jrig, p, gamma_sqrt, FD_STEP)
    return port_grads(trig, p, gamma_sqrt, accumulate_time=True), (vals, fd)


def check_fd(got, ref):
    (p_vals, p_dp, p_dg), (vals, fd) = got, ref
    assert np.isfinite(fd).all() and np.abs(fd[:, :-1]).max() > 1e-3
    np.testing.assert_allclose(p_vals, vals, **TOL["float64"])
    err = np.abs(np.concatenate([p_dp, p_dg[:, None]], axis=1) - fd) / (np.abs(fd) + 1.0)
    assert err.max() <= FD_TOL, err.max(axis=0)


@pytest.mark.parametrize("gamma_sqrt", [0.1, 0.0])
def test_grad_plain_matches_jax_make_nll_differences_full(gamma_sqrt):
    check_fd(*fd_case("full", OPTIMIZED, gamma_sqrt, steps=16))
