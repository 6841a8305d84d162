"""The two time rules of the Kvaerno3 plain version of the nll_fwd kernel
against the JAX package's ``make_nll`` (XLA), across the stimulus onset of
Hodgkin-Huxley reduced-4: t0 = 9.9 from the rest state, 200 steps.

JAX's ``make_nll`` accumulates the time (t += h in the working type). With
the running-sum rule (``accumulate_time``) the plain version agrees with it
at float64 rtol 1e-9; with the step-index rule (the kernel's, as JAX's tile
evaluator) the stimulus switches on one step earlier and the NLLs part: the
test records that the gap is there. Rigs from tests/test_torch_hh_nll.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ode_uncertainty_tpu.inference import make_nll as j_make_nll
from ode_uncertainty_tpu_torch.ops import nll_kernel
from test_torch_hh_nll import TOL, hh_rigs, points, port_args


def jax_nll(jrig, p, gamma_sqrt):
    nll = j_make_nll(*jrig)
    q = jnp.eye(jrig[0].dim)
    f = jax.jit(jax.vmap(lambda x, g: nll(x, q, g), in_axes=(0, None)))
    return np.asarray(f(jnp.asarray(p), jnp.asarray(gamma_sqrt)))


def test_time_rules_of_the_plain_version_against_jax_make_nll():
    jrig, trig = hh_rigs("reduced-4", "float64", 9.9, 200)
    p = points()
    ref = jax_nll(jrig, p, 0.1)
    run = lambda acc: nll_kernel.make_nll_tiles(*port_args(trig), trig.q_sqrt, accumulate_time=acc)(
        torch.as_tensor(p), 0.1).numpy()
    np.testing.assert_allclose(run(True), ref, **TOL["float64"])
    gap = np.abs(run(False) - ref) / np.abs(ref)
    assert gap.max() > 1e-6, gap  # the step-index rule meets the onset one step earlier
