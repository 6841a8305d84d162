"""The Kvaerno3 plain version of the nll_fwd kernel against the JAX
package's XLA ``make_nll`` through the first spike of Hodgkin-Huxley
reduced-4: x0 is the JAX Kvaerno3 solve's state at t = 23.5 (from the rest
state at t = 0; the first V > 0 is at t = 24.05), then 200 steps with V
observed after each. No stimulus edge lies inside the rig, so the two
routes' time rules (step index / running sum) agree. Tolerance: float64
rtol 1e-9. Rigs from tests/test_torch_hh_nll.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu import models as jm
from ode_uncertainty_tpu import solvers as js
from ode_uncertainty_tpu.inference import make_nll as j_make_nll
from ode_uncertainty_tpu_torch.ops import nll_kernel
from test_torch_hh_nll import TOL, hh_rigs, points, port_args

_STATE: dict = {}


def spike_state():
    """The reference state at t = 23.5 ([1, 4], numpy)."""
    if "x" not in _STATE:
        m = jm.hodgkin_huxley("reduced-4")
        x_rest = m.build_initial_value(jnp.array([[-70.0]]), m.params)
        sol = js.solve(js.kvaerno3(0.01), m, 0.0, x_rest, 2350)
        v = np.asarray(sol["x"])[:, 0, 0]
        assert abs(float(sol["t"][-1]) - 23.5) < 1e-9 and v.max() < 0.0
        _STATE["x"] = np.asarray(sol["x"][-1])
    return _STATE["x"]


def jax_nll(jrig, p, gamma_sqrt):
    nll = j_make_nll(*jrig)
    q = jnp.eye(jrig[0].dim)
    f = jax.jit(jax.vmap(lambda x, g: nll(x, q, g), in_axes=(0, None)))
    return np.asarray(f(jnp.asarray(p), jnp.asarray(gamma_sqrt)))


@pytest.mark.parametrize("gamma_sqrt", [0.1, 0.0])
def test_plain_version_matches_jax_make_nll_through_the_spike(gamma_sqrt):
    jrig, trig = hh_rigs("reduced-4", "float64", 23.5, 200, spike_state())
    p = points()
    got = nll_kernel.make_nll_tiles(*port_args(trig), trig.q_sqrt)(torch.as_tensor(p), gamma_sqrt).numpy()
    ref = jax_nll(jrig, p, gamma_sqrt)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL["float64"])
