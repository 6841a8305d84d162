// nll_fwd for van der Pol with the Kvaerno3 step, at every L in 1..n, in
// double, on a team of threads per lane (team_chain.cuh; one model, type
// and kernel a unit, so that nvcc builds them in parallel).

#include "nll_fwd.cuh"

ODEUQ_NLL_FWD_UNIT(odeuq_nll_fwd_kv3_vdp_f64, double, VanDerPol, true, VanDerPol::N, Kvaerno3)
