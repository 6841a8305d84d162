"""The time rule of the port's entry points: ``batched_nll``, which both
``evaluate`` and ``optimize`` call, against the JAX package's XLA
``make_nll`` (the route the JAX CLI takes on the shipped observation files)
across the stimulus onset of Hodgkin-Huxley reduced-4.

The rig starts at t0 = 9.9 from the rest state and runs 40 steps with V
observed after each. Counting steps from 0, step k starts at t0 + k h by the
step index (the kernels' default, as JAX's tile evaluator): step 10 starts
at t = 10 exactly and meets the stimulus (t >= 10) at its first stage. The
float64 running sum t += h (the XLA path's rule) starts step 10 at
9.999999999999998 and switches the stimulus on one step later, at step 11.
The test first asserts that the step-index rule misses JAX by more than
1e-6 relative on this rig (so that it can fail), then that the entry
point's wrapper equals JAX at float64 rtol 1e-9, at gamma^1/2 = 0.1 and 0.
Rigs and points from tests/test_torch_hh_nll.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu.inference import make_nll as j_make_nll
from ode_uncertainty_tpu_torch import run_parameter_estimation as rpe
from ode_uncertainty_tpu_torch.ops import nll_kernel
from test_torch_hh_nll import TOL, hh_rigs, points, port_args

T0, STEPS = 9.9, 40
_JIT: dict = {}


def jax_nll(p, gamma_sqrt):
    """JAX's XLA make_nll [B] on the rig (one jit; gamma is traced)."""
    if "f" not in _JIT:
        jrig = hh_rigs("reduced-4", "float64", T0, STEPS)[0]
        nll, q = j_make_nll(*jrig), jnp.eye(jrig[0].dim)
        _JIT["f"] = jax.jit(jax.vmap(lambda x, g: nll(x, q, g), in_axes=(0, None)))
    return np.asarray(_JIT["f"](jnp.asarray(p), jnp.asarray(gamma_sqrt, jnp.float64)))


def test_the_rig_puts_the_two_rules_on_different_onset_steps():
    _, trig = hh_rigs("reduced-4", "float64", T0, STEPS)
    h = trig.solver.h
    by_index = [T0 + k * h for k in range(STEPS)]
    running = [T0]
    for _ in range(STEPS - 1):
        running.append(running[-1] + h)
    onset = lambda times: next(k for k, t in enumerate(times) if t >= 10.0)
    assert (onset(by_index), onset(running)) == (10, 11)


@pytest.mark.parametrize("gamma_sqrt", [0.1, 0.0])
def test_entry_point_nll_matches_jax_make_nll_across_the_onset(gamma_sqrt):
    _, trig = hh_rigs("reduced-4", "float64", T0, STEPS)
    p = points()
    ref = jax_nll(p, gamma_sqrt)
    step_index = nll_kernel.make_nll_cuda(*port_args(trig), trig.q_sqrt)(torch.as_tensor(p), gamma_sqrt).numpy()
    gap = np.abs(step_index - ref) / np.abs(ref)
    assert gap.max() > 1e-6, gap  # the step-index rule meets the onset one step earlier
    nll_b, on_kernels = rpe.batched_nll(trig, {}, grad=True)
    assert on_kernels and nll_b.cm.accumulate_time
    got = nll_b(torch.as_tensor(p), gamma_sqrt).detach().numpy()
    np.testing.assert_allclose(got, ref, **TOL["float64"])
