// nll_fwd for logistic growth under every explicit tableau (Heun-Euler,
// Bogacki-Shampine 3(2), RKF45, Dormand-Prince 6(5)), at L = 1, in double
// (one model, type and kernel a unit, so that nvcc builds them in parallel).

#include "nll_fwd.cuh"

ODEUQ_NLL_FWD_UNIT(odeuq_nll_fwd_erk_logistic_f64, double, Logistic, false, Logistic::N, HeunEuler, Bs32, Rkf45, Dopri65)
