"""The plain versions of the Kvaerno3 NLL kernels (``nll_plain``,
``nll_grad_plain`` in ``ops/nll_kernel.py``, ``ChainMath._kvaerno3_step``) on
the models with a hand-written tile RHS, at one observed state (L = 1),
against the JAX package: its tile evaluator ``make_nll_tiles`` (run eagerly
under ``jax.disable_jit``) and its XLA ``make_nll``; the rigs and helpers of
tests/test_torch_erk_models.py (4 steps at h = 0.01, an observation every 2,
every parameter optimized, 8 lanes, gamma^1/2 = 0.1 and 0). The other
observation sizes and the gradients: tests/test_torch_kv3_sizes.py.
Tolerances: float64 rtol 1e-9; float32 rtol 5e-4 / atol 5e-3 against JAX's
float32 make_nll (the implicit value tolerance of
tests/test_pallas_ekf.py:314).
"""

import numpy as np
import pytest

from test_torch_erk_models import MODELS, _jax_values, _plain, _points, _rig, check_values


@pytest.mark.parametrize("model", list(MODELS))
def test_kvaerno3_plain_values_match_jax_tiles_and_make_nll(model):
    check_values(model, "kvaerno3", 1)


def test_kvaerno3_float32_plain_values_match_jax_make_nll():
    jrig, trig = _rig("van_der_pol", "kvaerno3", 1, "float32")
    p = _points(trig.spec.num_opt)
    for gamma_sqrt in (0.1, 0.0):
        got = _plain(trig, "float32", p, gamma_sqrt)
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got, _jax_values(jrig, "float32", p, gamma_sqrt), rtol=5e-4, atol=5e-3)
