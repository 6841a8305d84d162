// nll_fwd for Hodgkin-Huxley full under Heun-Euler, Bogacki-Shampine 3(2),
// RKF45 and Dormand-Prince 6(5), at L = 1, in float, on a team of threads per
// lane (team_chain.cuh; one model, type and kernel a unit, so that
// nvcc builds them in parallel).

#include "nll_fwd.cuh"

ODEUQ_NLL_FWD_UNIT(odeuq_nll_fwd_erk_hh8_f32, float, HodgkinHuxley<8>, true, 1, HeunEuler, Bs32, Rkf45, Dopri65)
