// nll_bwd for Hodgkin-Huxley reduced-4 under Heun-Euler, Bogacki-Shampine 3(2)
// and RKF45, at L = 1, in float, on a team of threads per lane and direction
// (team_chain.cuh; one model, type and kernel a unit, so that nvcc builds
// them in parallel; Dormand-Prince 6(5), whose ptxas takes longest, in
// nll_bwd_dopri65_hh4_f32.cu).

#include "nll_bwd.cuh"

ODEUQ_NLL_BWD_UNIT(odeuq_nll_bwd_erk_hh4_f32, float, HodgkinHuxley<4>, true, 1, HeunEuler, Bs32, Rkf45)
