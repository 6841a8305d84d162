// Gradient of the square-root EKF NLL on a uniform observation grid.
//
// Replaces the TPU kernel `bwd_kernel` of ode_uncertainty_tpu/ops/pallas_ekf.py
// (body `_bwd_body` :752-828, VMEM variant :851, HBM-snapshot variant :832,
// launched by `_bwd_call` :892) for an explicit Runge-Kutta step (every
// tableau; Lotka-Volterra here under RKF45, the units nll_bwd_erk_*.cu and
// nll_bwd_dopri65_hh*.cu for every model with a tile RHS,
// pallas_ekf.py:79-164, under every tableau) and for the Kvaerno3 step
// (`_make_sdirk_step_tiles` :291-364 with the stage solve's custom_jvp
// :301-332; the units nll_bwd_kv3_*.cu and nll_bwd_hh*.cu). Given the per-lane cotangent g of the NLL
// it computes, per lane and for each direction of the launch's list,
//   dphys[k] = g * dNLL/dphys[k]   for a parameter row k in the list,
//   dgamma   = g * dNLL/dgamma_sqrt (summed over lanes by the caller).
// The rows not in the list are left as the caller initialized them (the
// wrapper zeroes them): the optimizer asks for its optimized rows only.
// Its plain PyTorch version, which the tests and the on-card comparison hold
// this kernel against, is `nll_grad_plain` in
// ode_uncertainty_tpu_torch/ops/nll_kernel.py (reverse-mode autograd through
// the plain forward).
//
// Design on Hopper. The TPU kernel recomputes the forward, stores one (x, P)
// snapshot per observation interval and runs `jax.vjp` of the interval body
// in reverse; CUDA has no autodiff, and a hand-written adjoint of the
// Householder QR with its piecewise scale, sign and zero-column guard would
// be a second copy of the filter to keep right. Here the forward-mode JVP
// takes its place: the chain math of ekf_chain.cuh (the same code nll_fwd.cu
// runs) is instantiated on a dual number that carries one tangent, and one
// thread runs the whole chain for one (lane, direction) pair, the direction
// being one parameter row or gamma^1/2. The tangent of the NLL is then the
// exact directional derivative, and there is nothing to snapshot: the state
// per thread is twice the forward's, in registers. The grid is
// (ceil(B / 32), directions asked for); every thread recomputes the primal,
// which costs nothing in wall time while the launch fills less than the card.
//
// The Kvaerno3 step on duals (team_chain.cuh `team_predict`,
// `TeamStageSolution`): the simplified-Newton iterations run on the values
// only (the reference's base-point inverse is a stop_gradient and the
// guess's tangent is dropped); the stage solution's tangent is set by the
// implicit-function rule, (I - h g J(z*))^-1 (d known + h g df/dp dp), and
// the Jacobian at z* is a jet of duals, so J(z*), the solves with
// I - h g J(z*) and the stage tangents of P's columns carry their
// derivative: the rule differentiated, as JAX differentiates it in the TPU
// kernel's reverse sweep, never the unrolled iterations. Like the forward,
// the Kvaerno3 gradient is bound by the latency of one (lane, direction)'s
// chain of 10^4 steps; one thread per pair carried the forward's
// per-thread work on duals, a jet of duals of 10 values an entry, and
// spilled. Here a team of team_size(n) threads runs each (lane, direction)
// as the forward's team does (team_chain.cuh): thread c's Jacobian column
// is a jet of duals with one tangent (4 values an entry), the solves,
// QRs and products are shared by the team, and divisions run without the
// slow-path branch. Per implicit stage the rule adds one value Jacobian
// column, one dual RHS and one team solve. Hodgkin-Huxley reduced-4 (n = 4,
// a team of 4), reduced-1 (n = 7) and full (n = 8, a team of 8), one unit
// per variant and type (nll_bwd_hh{4,7,8}_{f32,f64}.cu); the tile models
// under Kvaerno3 (teams of 1, 2 and 4; nll_bwd_kv3_*.cu) and
// Hodgkin-Huxley under the explicit tableaus (nll_bwd_erk_hh*.cu,
// nll_bwd_dopri65_hh*.cu) run the same team chain on duals (nll_fwd.cu).
//
// Tangent rules: a comparison or a select (the QR's max-abs scale and its
// `scale > 0` guard, the sign, the zero-column guard `vnorm_sq > eps`) acts
// on the value and carries the tangent of the branch it takes; |v| has the
// tangent sign(v) dv with sign(0) = 0, as in PyTorch and JAX.
//
// Bound on the H100. Per (lane, direction) the dual arithmetic does about
// three times the forward's operations (a product is three, a quotient
// five), and a launch does one thread per (lane, direction); memory sees
// (2K + 2) B + n_obs L values. Like the forward it is latency-bound at the
// widths the optimizer dispatches (100 to 800 lanes, one to five
// directions): the time is one thread's dependent chain, now of dual
// operations, whose quotients and square roots (values and tangents) go
// through the branch-free div_t and sqrt_t. A team of 2 threads per (lane,
// direction) for the explicit step was measured 17% slower on an H100 SXM
// (kernel_probe.py): the dual chain of one column is no shorter on its own
// thread, and the QR's shuffles lengthen it.

#include "nll_bwd.cuh"

// One unit each (nll_bwd_{erk,kv3}_*.cu, nll_bwd_dopri65_hh*.cu,
// nll_bwd_hh*.cu): a model with a hand-written RHS under the explicit
// tableaus (Lotka-Volterra under all but RKF45, which is instantiated here; a
// thread per lane) and under Kvaerno3 (a team per lane), and each
// single-compartment Hodgkin-Huxley variant under the explicit tableaus
// (nll_bwd_erk_hh*.cu; Dormand-Prince in nll_bwd_dopri65_hh*.cu) and under
// Kvaerno3 (nll_bwd_hh*.cu), a team per lane, in float and double.
#define ODEUQ_DECLARE_UNIT(NAME) \
  extern "C" int NAME(int tableau, int obs_dim, const void* phys, int k_params, int batch, const void* ys, \
                      const double* rig, double gamma_sqrt, const void* g, const int* rows, int n_rows,     \
                      void* dphys, void* dgamma, void* stream);
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_lv_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_lv_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_lorenz_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_lorenz_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_vdp_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_vdp_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_pendulum_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_pendulum_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_logistic_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_logistic_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_exponential_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_exponential_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_kv3_lv_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_kv3_lv_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_kv3_lorenz_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_kv3_lorenz_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_kv3_vdp_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_kv3_vdp_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_kv3_pendulum_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_kv3_pendulum_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_kv3_logistic_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_kv3_logistic_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_kv3_exponential_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_kv3_exponential_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_hh4_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_hh4_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_hh7_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_hh7_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_hh8_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_erk_hh8_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_dopri65_hh4_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_dopri65_hh4_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_dopri65_hh7_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_dopri65_hh7_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_dopri65_hh8_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_dopri65_hh8_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_hh4_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_hh4_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_hh7_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_hh7_f64)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_hh8_f32)
ODEUQ_DECLARE_UNIT(odeuq_nll_bwd_hh8_f64)
#undef ODEUQ_DECLARE_UNIT

namespace {

using UnitBwd = int (*)(int, int, const void*, int, int, const void*, const double*, double, const void*,
                        const int*, int, void*, void*, void*);

// model id, state size n, parameter count and the unit's entries (float,
// double)
struct BwdUnit {
  int model;
  int n, k;
  UnitBwd f32, f64;
};
#define ODEUQ_UNIT(ID, MODEL, NAME) {ID, MODEL::N, MODEL::K, NAME##_f32, NAME##_f64}
constexpr BwdUnit kBwdUnits[] = {
    ODEUQ_UNIT(0, LotkaVolterra, odeuq_nll_bwd_erk_lv),
    ODEUQ_UNIT(4, Lorenz, odeuq_nll_bwd_erk_lorenz),
    ODEUQ_UNIT(5, VanDerPol, odeuq_nll_bwd_erk_vdp),
    ODEUQ_UNIT(6, Pendulum, odeuq_nll_bwd_erk_pendulum),
    ODEUQ_UNIT(7, Logistic, odeuq_nll_bwd_erk_logistic),
    ODEUQ_UNIT(8, Exponential, odeuq_nll_bwd_erk_exponential),
    ODEUQ_UNIT(0, LotkaVolterra, odeuq_nll_bwd_kv3_lv),
    ODEUQ_UNIT(4, Lorenz, odeuq_nll_bwd_kv3_lorenz),
    ODEUQ_UNIT(5, VanDerPol, odeuq_nll_bwd_kv3_vdp),
    ODEUQ_UNIT(6, Pendulum, odeuq_nll_bwd_kv3_pendulum),
    ODEUQ_UNIT(7, Logistic, odeuq_nll_bwd_kv3_logistic),
    ODEUQ_UNIT(8, Exponential, odeuq_nll_bwd_kv3_exponential),
    ODEUQ_UNIT(1, HodgkinHuxley<4>, odeuq_nll_bwd_erk_hh4),
    ODEUQ_UNIT(2, HodgkinHuxley<7>, odeuq_nll_bwd_erk_hh7),
    ODEUQ_UNIT(3, HodgkinHuxley<8>, odeuq_nll_bwd_erk_hh8),
    ODEUQ_UNIT(1, HodgkinHuxley<4>, odeuq_nll_bwd_dopri65_hh4),
    ODEUQ_UNIT(2, HodgkinHuxley<7>, odeuq_nll_bwd_dopri65_hh7),
    ODEUQ_UNIT(3, HodgkinHuxley<8>, odeuq_nll_bwd_dopri65_hh8),
    ODEUQ_UNIT(1, HodgkinHuxley<4>, odeuq_nll_bwd_hh4),
    ODEUQ_UNIT(2, HodgkinHuxley<7>, odeuq_nll_bwd_hh7),
    ODEUQ_UNIT(3, HodgkinHuxley<8>, odeuq_nll_bwd_hh8),
};
#undef ODEUQ_UNIT

}  // namespace

// dtype: 0 float32, 1 float64. model and tableau ids as in nll_fwd.cu.
// Instantiated: every tableau (the explicit ones and Kvaerno3) on
// Lotka-Volterra, Lorenz, van der Pol, the pendulum, logistic and
// exponential growth at every L in 1..n, and on the three Hodgkin-Huxley
// variants (n = 4, 7, 8) at L = 1.
// phys: [k_params, batch]; ys: [n_obs, obs_dim]; g: [batch] NLL cotangent;
// rows: the n_rows parameter rows to differentiate (host memory, distinct);
// out dphys: [k_params, batch], written on those rows; out dgamma: [batch]
// per-lane contributions to d/d gamma^1/2, or null to skip that direction.
// Returns 0, a cudaError_t code (> 0), the negative codes of odeuq_nll_fwd,
// or -4 for an invalid direction list.
extern "C" int odeuq_nll_bwd(int dtype, int n, int obs_dim, int model, int tableau,
                             const void* phys, int k_params, int batch, const void* ys,
                             const double* rig, double gamma_sqrt, const void* g, const int* rows,
                             int n_rows, void* dphys, void* dgamma, void* stream) {
  if (batch <= 0) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (model == 0 && tableau == 0 && n == LotkaVolterra::N && k_params >= LotkaVolterra::K) {
    if (dtype == 0 && obs_dim == 1)
      return launch<float, 1, LotkaVolterra, Rkf45>(phys, k_params, batch, ys, rig, gamma_sqrt, g,
                                                    rows, n_rows, dphys, dgamma, s);
    if (dtype == 0 && obs_dim == 2)
      return launch<float, 2, LotkaVolterra, Rkf45>(phys, k_params, batch, ys, rig, gamma_sqrt, g,
                                                    rows, n_rows, dphys, dgamma, s);
    if (dtype == 1 && obs_dim == 1)
      return launch<double, 1, LotkaVolterra, Rkf45>(phys, k_params, batch, ys, rig, gamma_sqrt, g,
                                                     rows, n_rows, dphys, dgamma, s);
    if (dtype == 1 && obs_dim == 2)
      return launch<double, 2, LotkaVolterra, Rkf45>(phys, k_params, batch, ys, rig, gamma_sqrt, g,
                                                     rows, n_rows, dphys, dgamma, s);
    return -1;
  }
  // a unit without this tableau or size returns -1: the next unit of the model may have it
  for (const BwdUnit& u : kBwdUnits)
    if (model == u.model && n == u.n && k_params >= u.k && (dtype == 0 || dtype == 1)) {
      const int err = (dtype == 0 ? u.f32 : u.f64)(tableau, obs_dim, phys, k_params, batch, ys, rig, gamma_sqrt, g,
                                                   rows, n_rows, dphys, dgamma, stream);
      if (err != -1) return err;
    }
  return -1;
}
