// nll_fwd for the pendulum under every explicit tableau (Heun-Euler,
// Bogacki-Shampine 3(2), RKF45, Dormand-Prince 6(5)), at every L in 1..n, in
// float (one model, type and kernel a unit, so that nvcc builds them in
// parallel).

#include "nll_fwd.cuh"

ODEUQ_NLL_FWD_UNIT(odeuq_nll_fwd_erk_pendulum_f32, float, Pendulum, false, Pendulum::N, HeunEuler, Bs32, Rkf45, Dopri65)
