// nll_fwd for Lorenz under every explicit tableau (Heun-Euler,
// Bogacki-Shampine 3(2), RKF45, Dormand-Prince 6(5)), at every L in 1..n, in
// float (one model, type and kernel a unit, so that nvcc builds them in
// parallel).

#include "nll_fwd.cuh"

ODEUQ_NLL_FWD_UNIT(odeuq_nll_fwd_erk_lorenz_f32, float, Lorenz, false, Lorenz::N, HeunEuler, Bs32, Rkf45, Dopri65)
