// nll_fwd for Hodgkin-Huxley reduced-1 with the Kvaerno3 step, at L = 1, in double
// (one instantiation a unit, so that nvcc builds them in parallel).

#include "nll_fwd.cuh"

ODEUQ_NLL_FWD_UNIT(odeuq_nll_fwd_hh7_f64, double, HodgkinHuxley<7>, true, 1, Kvaerno3)
