// Forward NLL of the square-root EKF on a uniform observation grid.
//
// Replaces the TPU kernel `fwd_kernel` of ode_uncertainty_tpu/ops/pallas_ekf.py
// (:722-742, launched by `_fwd_call` :866-890) for an explicit Runge-Kutta
// step (`_erk_step_tiles` :171, every tableau; Lotka-Volterra here under
// RKF45, the units nll_fwd_erk_*.cu for every model with a tile RHS,
// :79-164, under every tableau) and for the Kvaerno3 step
// (`_make_sdirk_step_tiles` :291-364; the units nll_fwd_kv3_*.cu and
// nll_fwd_hh*.cu), the reference's `supports` (:383-399) on the
// single-compartment models: every tile model at every L in 1..n, the
// Hodgkin-Huxley variants at L = 1. Its plain PyTorch version, which the tests
// and the on-card comparison hold this kernel against, is `nll_plain` in
// ode_uncertainty_tpu_torch/ops/nll_kernel.py. The per-lane math lives in
// ekf_chain.cuh, which the gradient kernel (nll_bwd.cu) shares.
//
// Per lane (one candidate parameter vector): `first + 1` predicts and a
// correct, then `n_obs - 1` intervals of `d` predicts and a Joseph-form
// correct, summing the innovation NLLs.
//   * predict: one embedded-RK step with the N columns of P carried as
//     forward-mode tangents through every stage (the JVP of the step, not
//     J_f(x) P), then P <- R^T of the Householder QR of [P_pred^T; (g Q)^T].
//   * correct: at L = 1 the innovation's 1 x 1 factor s as the scaled norm
//     of [(H P)^T; R] and one reciprocal of s for the gain; at L = 2, S from
//     the QR of [(H P)^T; R^T] and the gain by two triangular
//     substitutions; then x and P updated in Joseph form, NLL of the
//     innovation.
//
// Design on Hopper. The TPU kernel put 1024 lanes in an (8, 128) vector tile
// and unrolled the small-matrix algebra over lists of tiles. Here one thread
// is one lane: x[N] and P[N][N] and every stage value live in registers, the
// interval and predict loops are loops inside the thread (nothing unrolled
// over the 2000 steps), and the Butcher tableau is a compile-time constant so
// structural zeros and the dead error-estimator stage vanish. Inputs are the
// [K, B] parameter rows (one coalesced read per parameter), the [n_obs, L]
// observations that all lanes read in step (broadcast loads from L1/L2) and
// one by-value struct of constants; the output is one value per lane.
//
// Bound on the H100. Lotka-Volterra with RKF45 does about 440 operations per
// lane for a predict (5 live stages of RHS + 2 tangent columns, 10 stage
// combinations and 4 solution weights over 6 values, a 4x2 QR with two
// square roots and 10 divisions) and about 175 for a correct with L = 1
// (310 with L = 2), as chip_smoke.py counts them in the plain version. No
// dispatch of the main path fills the card (100 to 800 lanes; bench.py's
// 8192 lanes are 256 warps over 132 SMs x 4 schedulers), so nothing hides
// latency: the time is the dependent chain of one lane's 2000 steps, the
// same at B = 1 and B = 8192, not the 67 TFLOP/s float32 issue rate and not
// memory, which sees K*B + n_obs*L + B values in all. So every quotient and
// square root goes through div_t and sqrt_t (ekf_chain.cuh): the IEEE
// operations' slow-path branch after each of ~24 divisions and 5 square
// roots a step cut the step into basic blocks that the scheduler could not
// overlap. Measured on an H100 SXM (700 W, float32, L = 1, kernel_probe.py):
// with the branches ~0.84 us a predict and ~1.23 us a correct; without them
// ~0.37 us and ~0.44 us, where the operations of one step of 256 lanes take
// ~2.4 ns at the peak rate. A team of 2 threads per lane (thread c owning
// column c of P, the QR by shuffles, as the Kvaerno3 chain does) was
// measured 12% slower for this kernel: both columns' tangents already
// overlap in one thread, and the shuffles lengthen every QR column.
//
// The Kvaerno3 step (Hodgkin-Huxley, n = 4, 7, 8, L = 1, 10^4 steps). Per
// step: the Jacobian at the base point, the inverse of I - h g J for the
// Newton iterations, then three implicit stages of `newton_iters` (6)
// simplified-Newton iterations, each stage ending with the Jacobian at its
// solution and the tangents of P's columns through the implicit-function
// rule. What bounds it is latency, not bytes or operations: the evaluate
// batch is 100 lanes, and a launch takes as long as one lane's chain of
// 10^4 dependent steps (the same at B = 1 and B = 256). With one thread per
// lane that chain took ~49,000 cycles a step on an H100 SXM: four Jacobians on
// an n-tangent jet, four n x n inverses, n^2 stage tangents and the QRs in
// one thread, registers spilling at n = 7 and 8, and an IEEE division
// after every rate law whose slow-path branch kept the scheduler from
// overlapping independent work. Here a team of team_size(n) threads runs
// each lane (team_chain.cuh): thread c owns column c of P, evaluates column
// c of each Jacobian on a one-tangent jet, and the team shares the solves
// with I - h g J (Gauss-Jordan over its columns, pivot columns broadcast by
// shuffles), the QRs (shuffle-xor sums over the team) and the full-matrix
// products (a per-team slab of shared memory); divisions run without the
// slow-path branch (div_t, ekf_chain.cuh). The Newton iterations stay one
// chain of RHS evaluations that every thread of the team runs, and are
// now the larger part of a step. One warp a block, so the lanes of a
// dispatch spread over the SMs, one warp each.
//
// The same team chain runs Kvaerno3 on the tile models (teams of 1, 2 and 4
// for n = 1, 2, 3; a column of the Jacobian from the model's hand-written
// JVP along e_c; with L > 1 observed rows every thread of the team runs the
// per-thread correct on the gathered P) and Hodgkin-Huxley under the
// explicit tableaus: one thread per lane would carry every stage's n
// tangent columns (Dormand-Prince at n = 8: 8 x 8 stage values and
// 8 x 8 x 8 tangents, ~1,150 words in float64) against 255 registers, so
// thread c carries column c's tangent through the stages (one jet
// evaluation of the RHS a stage gives the stage slope and that tangent) and
// the team shares only the QRs.

#include "nll_fwd.cuh"

// One unit each (nll_fwd_{erk,kv3}_*.cu, nll_fwd_hh*.cu): a model with a
// hand-written RHS under the explicit tableaus (Lotka-Volterra under all but
// RKF45, which is instantiated here; a thread per lane) and under Kvaerno3 (a
// team per lane), and each single-compartment Hodgkin-Huxley variant under
// the explicit tableaus (nll_fwd_erk_hh*.cu) and under Kvaerno3
// (nll_fwd_hh*.cu), a team per lane, in float and double.
#define ODEUQ_DECLARE_UNIT(NAME) \
  extern "C" int NAME(int tableau, int obs_dim, const void* phys, int batch, const void* ys,       \
                      const double* rig, double gamma_sqrt, void* out, void* stream);
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_lv_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_lv_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_lorenz_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_lorenz_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_vdp_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_vdp_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_pendulum_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_pendulum_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_logistic_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_logistic_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_exponential_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_exponential_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_kv3_lv_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_kv3_lv_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_kv3_lorenz_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_kv3_lorenz_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_kv3_vdp_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_kv3_vdp_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_kv3_pendulum_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_kv3_pendulum_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_kv3_logistic_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_kv3_logistic_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_kv3_exponential_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_kv3_exponential_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_hh4_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_hh4_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_hh7_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_hh7_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_hh8_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_erk_hh8_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_hh4_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_hh4_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_hh7_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_hh7_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_hh8_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_fwd_hh8_f64)
#undef ODEUQ_DECLARE_UNIT

namespace {

using UnitFwd = int (*)(int, int, const void*, int, const void*, const double*, double, void*, void*);

// model id, state size n, parameter count and the unit's entries (float,
// double)
struct FwdUnit {
  int model;
  int n, k;
  UnitFwd f32, f64;
};
#define ODEUQ_UNIT(ID, MODEL, NAME) {ID, MODEL::N, MODEL::K, NAME##_f32, NAME##_f64}
constexpr FwdUnit kFwdUnits[] = {
    ODEUQ_UNIT(0, LotkaVolterra, odeuq_nll_fwd_erk_lv),
    ODEUQ_UNIT(4, Lorenz, odeuq_nll_fwd_erk_lorenz),
    ODEUQ_UNIT(5, VanDerPol, odeuq_nll_fwd_erk_vdp),
    ODEUQ_UNIT(6, Pendulum, odeuq_nll_fwd_erk_pendulum),
    ODEUQ_UNIT(7, Logistic, odeuq_nll_fwd_erk_logistic),
    ODEUQ_UNIT(8, Exponential, odeuq_nll_fwd_erk_exponential),
    ODEUQ_UNIT(0, LotkaVolterra, odeuq_nll_fwd_kv3_lv),
    ODEUQ_UNIT(4, Lorenz, odeuq_nll_fwd_kv3_lorenz),
    ODEUQ_UNIT(5, VanDerPol, odeuq_nll_fwd_kv3_vdp),
    ODEUQ_UNIT(6, Pendulum, odeuq_nll_fwd_kv3_pendulum),
    ODEUQ_UNIT(7, Logistic, odeuq_nll_fwd_kv3_logistic),
    ODEUQ_UNIT(8, Exponential, odeuq_nll_fwd_kv3_exponential),
    ODEUQ_UNIT(1, HodgkinHuxley<4>, odeuq_nll_fwd_erk_hh4),
    ODEUQ_UNIT(2, HodgkinHuxley<7>, odeuq_nll_fwd_erk_hh7),
    ODEUQ_UNIT(3, HodgkinHuxley<8>, odeuq_nll_fwd_erk_hh8),
    ODEUQ_UNIT(1, HodgkinHuxley<4>, odeuq_nll_fwd_hh4),
    ODEUQ_UNIT(2, HodgkinHuxley<7>, odeuq_nll_fwd_hh7),
    ODEUQ_UNIT(3, HodgkinHuxley<8>, odeuq_nll_fwd_hh8),
};
#undef ODEUQ_UNIT

}  // namespace

// dtype: 0 float32, 1 float64. model: 0 Lotka-Volterra, 1 Hodgkin-Huxley
// reduced-4, 2 reduced-1, 3 full, 4 Lorenz, 5 van der Pol, 6 pendulum, 7
// logistic, 8 exponential. tableau: 0 RKF45, 1 Kvaerno3, 2 Heun-Euler, 3
// Bogacki-Shampine 3(2), 4 Dormand-Prince 6(5). Instantiated: every tableau
// on models 0 and 4-8 at every L in 1..n, and on models 1-3 at L = 1.
// phys: [k_params, batch] physical parameters; ys: [n_obs, obs_dim]; out: [batch].
// Returns 0, a cudaError_t code (> 0), or a negative code for a configuration
// no instantiation covers.
extern "C" int odeuq_nll_fwd(int dtype, int n, int obs_dim, int model, int tableau,
                             const void* phys, int k_params, int batch, const void* ys,
                             const double* rig, double gamma_sqrt, void* out, void* stream) {
  if (batch <= 0) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (model == 0 && tableau == 0 && n == LotkaVolterra::N && k_params >= LotkaVolterra::K) {
    if (dtype == 0 && obs_dim == 1)
      return launch<float, 1, LotkaVolterra, Rkf45>(phys, batch, ys, rig, gamma_sqrt, out, s);
    if (dtype == 0 && obs_dim == 2)
      return launch<float, 2, LotkaVolterra, Rkf45>(phys, batch, ys, rig, gamma_sqrt, out, s);
    if (dtype == 1 && obs_dim == 1)
      return launch<double, 1, LotkaVolterra, Rkf45>(phys, batch, ys, rig, gamma_sqrt, out, s);
    if (dtype == 1 && obs_dim == 2)
      return launch<double, 2, LotkaVolterra, Rkf45>(phys, batch, ys, rig, gamma_sqrt, out, s);
    return -1;
  }
  // a unit without this tableau or size returns -1: the next unit of the model may have it
  for (const FwdUnit& u : kFwdUnits)
    if (model == u.model && n == u.n && k_params >= u.k && (dtype == 0 || dtype == 1)) {
      const int err =
          (dtype == 0 ? u.f32 : u.f64)(tableau, obs_dim, phys, batch, ys, rig, gamma_sqrt, out, stream);
      if (err != -1) return err;
    }
  return -1;
}

extern "C" const char* odeuq_error_string(int code) {
  if (code == -1) return "no kernel instantiation for this model, tableau, state or observation size";
  if (code == -2) return "empty batch";
  if (code == -3) return "invalid observation grid";
  if (code == -4) return "invalid direction list";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
