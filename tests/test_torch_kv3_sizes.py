"""The plain versions of the NLL kernels on the chains instantiated beyond
one observed state: Kvaerno3 on Lotka-Volterra, van der Pol and the
pendulum at L = 2 and on Lorenz at L = 2 and 3, and Lorenz at L = 2 under
every explicit tableau; and the Kvaerno3 gradient at L = 1 on van der Pol
and the pendulum. Against JAX's ``make_nll_tiles`` (eagerly) and XLA
``make_nll`` / ``jax.grad`` on the rigs and helpers of
tests/test_torch_erk_models.py. Tolerance: float64 rtol 1e-9 (values and
gradients).
"""

import pytest

from test_torch_erk_models import TABLEAUS, check_gradient, check_values


@pytest.mark.parametrize("model,L", [("lotka_volterra", 2), ("van_der_pol", 2), ("pendulum", 2), ("lorenz", 2),
                                     ("lorenz", 3)])
def test_kvaerno3_plain_values_at_more_observed_states(model, L):
    check_values(model, "kvaerno3", L)


@pytest.mark.parametrize("tableau", TABLEAUS)
def test_lorenz_two_observed_states_under_every_explicit_tableau(tableau):
    check_values("lorenz", tableau, 2)


@pytest.mark.parametrize("model", ["van_der_pol", "pendulum"])
def test_kvaerno3_plain_gradient_matches_jax_grad_of_make_nll(model):
    check_gradient(model, "kvaerno3", 1, "float64")
