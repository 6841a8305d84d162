"""The gradient of the Kvaerno3 plain version of the NLL kernels
(``nll_grad_plain``) against ``jax.grad`` of the JAX package's tile
evaluator ``make_nll_tiles``, the math of ``bwd_kernel``, with the tiles'
step-index time rule, on Hodgkin-Huxley reduced-4 (g_Na and g_K optimized).

The tile program runs eagerly (``jax.disable_jit``; compiled, its unrolled
Kvaerno3 steps take minutes to build on one CPU core), so the rig is the
shortest that crosses the stimulus onset: t0 = 9.99 from the rest state,
2 steps, the second starting at t = 10. One point; d NLL / d p_norm and
d NLL / d gamma^1/2 agree at float64 rtol 1e-9. Rigs from
tests/test_torch_hh_nll.py.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ode_uncertainty_tpu.ops.pallas_ekf import make_nll_tiles as j_tiles
from ode_uncertainty_tpu_torch.ops import nll_kernel
from test_torch_hh_grad import check, port_grads
from test_torch_hh_nll import hh_rigs, points


def test_grad_plain_matches_jax_tiles_grad_across_the_onset():
    jrig, trig = hh_rigs("reduced-4", "float64", 9.99, 2)
    cm = nll_kernel.build_chain_math(trig.model, trig.solver, trig.spec, trig.obs, trig.state0, trig.q_sqrt)
    assert cm.t0 < 10.0 <= cm.t_start(1)  # the second step meets the onset
    p = points(1)
    nll_t = j_tiles(*jrig, np.eye(trig.model.dim))
    with jax.disable_jit():
        val, (dp, dg) = jax.value_and_grad(lambda x, g: nll_t(x[None], g)[0], argnums=(0, 1))(
            jnp.asarray(p[0]), jnp.asarray(0.1, jnp.float64))
    grads = np.concatenate([np.asarray(dp), [float(dg)]])[None]
    check(port_grads(trig, p, 0.1, accumulate_time=False), np.asarray([float(val)]), grads)
