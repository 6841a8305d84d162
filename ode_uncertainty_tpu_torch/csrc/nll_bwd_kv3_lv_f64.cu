// nll_bwd for Lotka-Volterra with the Kvaerno3 step, at every L in 1..n, in
// double, on a team of threads per lane and direction (team_chain.cuh;
// one model, type and kernel a unit, so that nvcc builds them in parallel).

#include "nll_bwd.cuh"

ODEUQ_NLL_BWD_UNIT(odeuq_nll_bwd_kv3_lv_f64, double, LotkaVolterra, true, LotkaVolterra::N, Kvaerno3)
