// nll_bwd for Hodgkin-Huxley reduced-4 with the Kvaerno3 step, at L = 1, in float
// (one instantiation a unit, so that nvcc builds them in parallel).

#include "nll_bwd.cuh"

ODEUQ_NLL_BWD_UNIT(odeuq_nll_bwd_hh4_f32, float, HodgkinHuxley<4>, true, 1, Kvaerno3)
