// Gradient of the square-root EKF NLL on a uniform observation grid.
//
// Replaces the TPU kernel `bwd_kernel` of ode_uncertainty_tpu/ops/pallas_ekf.py
// (body `_bwd_body` :752-828, VMEM variant :851, HBM-snapshot variant :832,
// launched by `_bwd_call` :892) for an explicit Runge-Kutta step. Given the
// per-lane cotangent g of the NLL it computes, per lane,
//   dphys[k] = g * dNLL/dphys[k]   for every row k of the parameter matrix,
//   dgamma   = g * dNLL/dgamma_sqrt (summed over lanes by the caller).
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
// (ceil(B / 32), directions); every thread recomputes the primal, which
// costs nothing in wall time while the launch fills less than the card.
//
// Tangent rules: a comparison or a select (the QR's max-abs scale and its
// `scale > 0` guard, the sign, the zero-column guard `vnorm_sq > eps`) acts
// on the value and carries the tangent of the branch it takes; |v| has the
// tangent sign(v) dv with sign(0) = 0, as in PyTorch and JAX.
//
// Bound on the H100. Per (lane, direction) the dual arithmetic does about
// three times the forward's operations (a product is three, a quotient
// five), and the launch does K + 1 directions (5 for Lotka-Volterra), so the
// operations are ~15x the forward launch's; memory sees (2K + 2) B +
// n_obs L values. Like the forward it is latency-bound at the widths the
// optimizer dispatches (100 to 800 lanes, 500 to 4000 threads): the time is
// one thread's dependent chain, now of dual operations.

#include "dual.cuh"
#include "ekf_chain.cuh"

namespace {

constexpr int kThreads = 32;

// blockIdx.y is the direction: rows 0..k_params-1 of the parameter matrix,
// then (if dgamma is not null) gamma^1/2.
template <typename S, int N, int L, class Model, class Tab>
__global__ void __launch_bounds__(kThreads)
    nll_bwd_kernel(const S* __restrict__ phys, int k_params, int batch, const S* __restrict__ ys,
                   const Rig<S, N, L> rig, const S gamma_sqrt, const S* __restrict__ g,
                   S* __restrict__ dphys, S* __restrict__ dgamma) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int dir = blockIdx.y;
  if (lane >= batch) return;
  const typename Model::template Params<S> p = Model::template load<S>(phys, batch, lane, rig.poff);
  const typename Model::template Params<Dual<S>> pd = seed(p, rig.poff, dir);
  const Dual<S> gs(gamma_sqrt, S(dir == k_params));
  const Dual<S> nll = chain_nll<Dual<S>, N, L, Model, Tab>(rig, pd, gs, ys);
  const S out = g[lane] * nll.d;
  if (dir < k_params)
    dphys[static_cast<size_t>(dir) * batch + lane] = out;
  else
    dgamma[lane] = out;
}

template <typename S, int L, class Model, class Tab>
int launch(const void* phys, int k_params, int batch, const void* ys, const double* rig_host,
           double gamma_sqrt, const void* g, void* dphys, void* dgamma, cudaStream_t stream) {
  constexpr int N = Model::N;
  const Rig<S, N, L> rig = unpack_rig<S, N, L, Model>(rig_host);
  if (rig.n_obs < 1 || rig.d < 1 || rig.first < 0) return -3;
  const dim3 grid((batch + kThreads - 1) / kThreads, k_params + (dgamma != nullptr ? 1 : 0));
  nll_bwd_kernel<S, N, L, Model, Tab><<<grid, kThreads, 0, stream>>>(
      static_cast<const S*>(phys), k_params, batch, static_cast<const S*>(ys), rig, S(gamma_sqrt),
      static_cast<const S*>(g), static_cast<S*>(dphys), static_cast<S*>(dgamma));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64. model: 0 Lotka-Volterra. tableau: 0 RKF45.
// phys: [k_params, batch]; ys: [n_obs, obs_dim]; g: [batch] NLL cotangent;
// out dphys: [k_params, batch]; out dgamma: [batch] per-lane contributions
// to d/d gamma^1/2, or null to skip that direction.
// Returns 0, a cudaError_t code (> 0), or the negative codes of odeuq_nll_fwd.
extern "C" int odeuq_nll_bwd(int dtype, int n, int obs_dim, int model, int tableau,
                             const void* phys, int k_params, int batch, const void* ys,
                             const double* rig, double gamma_sqrt, const void* g, void* dphys,
                             void* dgamma, void* stream) {
  if (model != 0 || tableau != 0 || n != LotkaVolterra::N || k_params < LotkaVolterra::K)
    return -1;
  if (batch <= 0) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && obs_dim == 1)
    return launch<float, 1, LotkaVolterra, Rkf45>(phys, k_params, batch, ys, rig, gamma_sqrt, g,
                                                  dphys, dgamma, s);
  if (dtype == 0 && obs_dim == 2)
    return launch<float, 2, LotkaVolterra, Rkf45>(phys, k_params, batch, ys, rig, gamma_sqrt, g,
                                                  dphys, dgamma, s);
  if (dtype == 1 && obs_dim == 1)
    return launch<double, 1, LotkaVolterra, Rkf45>(phys, k_params, batch, ys, rig, gamma_sqrt, g,
                                                   dphys, dgamma, s);
  if (dtype == 1 && obs_dim == 2)
    return launch<double, 2, LotkaVolterra, Rkf45>(phys, k_params, batch, ys, rig, gamma_sqrt, g,
                                                   dphys, dgamma, s);
  return -1;
}
