// nll_bwd for exponential growth under every explicit tableau (Heun-Euler,
// Bogacki-Shampine 3(2), RKF45, Dormand-Prince 6(5)), at L = 1, in double
// (one model, type and kernel a unit, so that nvcc builds them in parallel).

#include "nll_bwd.cuh"

ODEUQ_NLL_BWD_UNIT(odeuq_nll_bwd_erk_exponential_f64, double, Exponential, false, Exponential::N, HeunEuler, Bs32, Rkf45, Dopri65)
