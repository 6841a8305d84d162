// nll_bwd for Hodgkin-Huxley full under Dormand-Prince 6(5), at L = 1, in
// float, on a team of threads per lane and direction (team_chain.cuh; a unit
// of its own, so that nvcc builds it beside the other tableaus').

#include "nll_bwd.cuh"

ODEUQ_NLL_BWD_UNIT(odeuq_nll_bwd_dopri65_hh8_f32, float, HodgkinHuxley<8>, true, 1, Dopri65)
