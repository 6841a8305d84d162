// Forward NLL of the square-root EKF on a uniform observation grid.
//
// Replaces the TPU kernel `fwd_kernel` of ode_uncertainty_tpu/ops/pallas_ekf.py
// (:722-742, launched by `_fwd_call` :866-890) for an explicit Runge-Kutta
// step (`_erk_step_tiles` :171). Its plain PyTorch version, which the tests
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
//   * correct: S from the QR of [(H P)^T; R^T], the gain by two triangular
//     substitutions, x and P updated in Joseph form, NLL of the innovation.
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
// (310 with L = 2), as chip_smoke.py counts them in the plain version. The
// bench batch is 8192 lanes = 256 warps over 132 SMs x 4 schedulers, so no
// scheduler holds more than one warp and nothing hides latency: the time is
// the dependent chain of one step (five RK stages in sequence, then the QR's
// max-reduction, square roots and divisions, then the correct's
// substitutions and log), not the 67 TFLOP/s f32 issue rate and not memory,
// which sees K*B + n_obs*L + B values in all. Measured on an H100 SXM
// (700 W, float32, chip_smoke.py): ~1.4 us a predict and ~1.1 us a
// correct, where the operations of one step of 256 lanes would take
// ~2.4 ns at the peak rate.

#include "ekf_chain.cuh"

namespace {

constexpr int kThreads = 32;

template <typename T, int N, int L, class Model, class Tab>
__global__ void __launch_bounds__(kThreads)
    nll_fwd_kernel(const T* __restrict__ phys, int batch, const T* __restrict__ ys,
                   const Rig<T, N, L> rig, const T gamma_sqrt, T* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  const typename Model::template Params<T> p = Model::template load<T>(phys, batch, lane, rig.poff);
  out[lane] = chain_nll<T, N, L, Model, Tab>(rig, p, gamma_sqrt, ys);
}

template <typename T, int L, class Model, class Tab>
int launch(const void* phys, int batch, const void* ys, const double* rig_host, double gamma_sqrt,
           void* out, cudaStream_t stream) {
  constexpr int N = Model::N;
  const Rig<T, N, L> rig = unpack_rig<T, N, L, Model>(rig_host);
  if (rig.n_obs < 1 || rig.d < 1 || rig.first < 0) return -3;
  const int blocks = (batch + kThreads - 1) / kThreads;
  nll_fwd_kernel<T, N, L, Model, Tab><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(phys), batch, static_cast<const T*>(ys), rig, T(gamma_sqrt),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64. model: 0 Lotka-Volterra. tableau: 0 RKF45.
// phys: [k_params, batch] physical parameters; ys: [n_obs, obs_dim]; out: [batch].
// Returns 0, a cudaError_t code (> 0), or a negative code for a configuration
// no instantiation covers.
extern "C" int odeuq_nll_fwd(int dtype, int n, int obs_dim, int model, int tableau,
                             const void* phys, int k_params, int batch, const void* ys,
                             const double* rig, double gamma_sqrt, void* out, void* stream) {
  if (model != 0 || tableau != 0 || n != LotkaVolterra::N || k_params < LotkaVolterra::K)
    return -1;
  if (batch <= 0) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

extern "C" const char* odeuq_error_string(int code) {
  if (code == -1) return "no kernel instantiation for this model, tableau, state or observation size";
  if (code == -2) return "empty batch";
  if (code == -3) return "invalid observation grid";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
