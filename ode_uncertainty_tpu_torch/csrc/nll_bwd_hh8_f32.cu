// nll_bwd for Hodgkin-Huxley full with the Kvaerno3 step, in float
// (one instantiation a unit, so that nvcc builds them in parallel).

#include "nll_bwd.cuh"

ODEUQ_NLL_BWD_KVAERNO3(odeuq_nll_bwd_hh8_f32, float, 8)
