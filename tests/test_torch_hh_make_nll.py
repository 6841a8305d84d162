"""The port's ``make_nll`` with the Kvaerno3 solver (its linearization runs
``torch.func.jvp`` through the stage-solve rule) against the JAX package's
``make_nll`` across the stimulus onset of Hodgkin-Huxley reduced-4.

Both ``make_nll``s accumulate the time (t += h in the working type), so with
t0 = 9.9 the stimulus switches on at their eleventh step (t = 10.009999...),
while the tiles' rule (step index) switches it on at the tenth (t = 10).
The port's ``make_nll`` runs 15 steps: it costs ~1 s a step on one CPU core.
Tolerance: float64 rtol 1e-9. Rigs from tests/test_torch_hh_nll.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu.inference import make_nll as j_make_nll
from ode_uncertainty_tpu_torch.inference import make_nll as t_make_nll
from test_torch_hh_nll import TOL, hh_rigs, points, port_args


def jax_nll(jrig, p, gamma_sqrt):
    nll = j_make_nll(*jrig)
    q = jnp.eye(jrig[0].dim)
    f = jax.jit(jax.vmap(lambda x, g: nll(x, q, g), in_axes=(0, None)))
    return np.asarray(f(jnp.asarray(p), jnp.asarray(gamma_sqrt)))


@pytest.mark.parametrize("gamma_sqrt", [0.1, 0.0])
def test_port_make_nll_matches_jax_make_nll_across_the_onset(gamma_sqrt):
    jrig, trig = hh_rigs("reduced-4", "float64", 9.9, 15)
    p = points(3)
    nll = t_make_nll(*port_args(trig))
    got = nll(torch.as_tensor(p), trig.q_sqrt, torch.tensor(gamma_sqrt, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(got, jax_nll(jrig, p, gamma_sqrt), **TOL["float64"])
