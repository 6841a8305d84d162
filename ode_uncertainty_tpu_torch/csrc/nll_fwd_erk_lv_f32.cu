// nll_fwd for Lotka-Volterra under Heun-Euler, Bogacki-Shampine 3(2) and
// Dormand-Prince 6(5) (RKF45: nll_fwd.cu), at every L in 1..n, in float (one
// model, type and kernel a unit, so that nvcc builds them in parallel).

#include "nll_fwd.cuh"

ODEUQ_NLL_FWD_UNIT(odeuq_nll_fwd_erk_lv_f32, float, LotkaVolterra, false, LotkaVolterra::N, HeunEuler, Bs32, Dopri65)
