"""The plain versions of the explicit-step NLL kernels under every ERK
tableau (Heun-Euler, Bogacki-Shampine 3(2), Dormand-Prince 6(5); RKF45 in
tests/test_torch_erk_models.py) on van der Pol (n = 2) and Lorenz (n = 3),
against JAX's ``make_nll_tiles`` and ``make_nll`` with ``jax.grad``, on the
rigs and at the tolerances of tests/test_torch_erk_models.py: the values at
L = 1 and L = n, the gradient on van der Pol at L = 1, on Lorenz with
Dormand-Prince at L = 3 and in float32 with Bogacki-Shampine at L = 1.
"""

import pytest

from test_torch_erk_models import check_gradient, check_values

OTHER_TABLEAUS = ("heun_euler", "bs32", "dopri65")


@pytest.mark.parametrize("model,tableau,L", [(m, tab, L) for m, n in (("van_der_pol", 2), ("lorenz", 3))
                                             for tab in OTHER_TABLEAUS for L in (1, n)])
def test_plain_values_match_jax_tiles_and_make_nll(model, tableau, L):
    check_values(model, tableau, L)


@pytest.mark.parametrize("model,tableau,L,dtype", [("van_der_pol", "heun_euler", 1, "float64"),
                                                   ("van_der_pol", "bs32", 1, "float64"),
                                                   ("lorenz", "dopri65", 3, "float64"),
                                                   ("lorenz", "bs32", 1, "float32")])
def test_plain_gradient_matches_jax_grad_of_make_nll(model, tableau, L, dtype):
    check_gradient(model, tableau, L, dtype)
