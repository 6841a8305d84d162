// nll_bwd for Lorenz under every explicit tableau (Heun-Euler,
// Bogacki-Shampine 3(2), RKF45, Dormand-Prince 6(5)), at every L in 1..n, in
// double (one model, type and kernel a unit, so that nvcc builds them in
// parallel).

#include "nll_bwd.cuh"

ODEUQ_NLL_BWD_UNIT(odeuq_nll_bwd_erk_lorenz_f64, double, Lorenz, false, Lorenz::N, HeunEuler, Bs32, Rkf45, Dopri65)
