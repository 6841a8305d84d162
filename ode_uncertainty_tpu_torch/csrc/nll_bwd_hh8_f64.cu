// nll_bwd for Hodgkin-Huxley full with the Kvaerno3 step, at L = 1, in double
// (one instantiation a unit, so that nvcc builds them in parallel).

#include "nll_bwd.cuh"

ODEUQ_NLL_BWD_UNIT(odeuq_nll_bwd_hh8_f64, double, HodgkinHuxley<8>, true, 1, Kvaerno3)
