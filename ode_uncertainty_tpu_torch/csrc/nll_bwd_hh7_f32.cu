// nll_bwd for Hodgkin-Huxley reduced-1 with the Kvaerno3 step, at L = 1, in float
// (one instantiation a unit, so that nvcc builds them in parallel).

#include "nll_bwd.cuh"

ODEUQ_NLL_BWD_UNIT(odeuq_nll_bwd_hh7_f32, float, HodgkinHuxley<7>, true, 1, Kvaerno3)
