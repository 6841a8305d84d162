// The NLL-gradient kernel template and its launcher, shared by nll_bwd.cu
// (the dispatcher and the Lotka-Volterra instantiations) and the
// nll_bwd_hh*.cu units, one Kvaerno3 Hodgkin-Huxley instantiation each (so
// that nvcc builds them in parallel). See nll_bwd.cu for the design.

#pragma once

#include "dual.cuh"
#include "ekf_chain.cuh"

namespace {

constexpr int kThreads = 32;

// The directions of one launch: parameter rows, and k_params for
// gamma^1/2. Passed by value (the constant bank).
struct Directions {
  int count;
  int row[kMaxParams + 1];
};

// blockIdx.y indexes the direction list.
template <typename S, int N, int L, class Model, class Tab>
__global__ void __launch_bounds__(kThreads)
    nll_bwd_kernel(const S* __restrict__ phys, int k_params, int batch, const S* __restrict__ ys,
                   const Rig<S, N, L> rig, const S gamma_sqrt, const S* __restrict__ g,
                   const Directions dirs, S* __restrict__ dphys, S* __restrict__ dgamma) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int dir = dirs.row[blockIdx.y];
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

// rows[0..n_rows): parameter rows; gamma^1/2 too when dgamma is not null.
template <typename S, int L, class Model, class Tab>
int launch(const void* phys, int k_params, int batch, const void* ys, const double* rig_host,
           double gamma_sqrt, const void* g, const int* rows, int n_rows, void* dphys, void* dgamma,
           cudaStream_t stream) {
  constexpr int N = Model::N;
  const Rig<S, N, L> rig = unpack_rig<S, N, L, Model>(rig_host);
  if (rig.n_obs < 1 || rig.d < 1 || rig.first < 0 || rig.newton_iters < 0) return -3;
  if (n_rows < 0 || n_rows > k_params || n_rows > kMaxParams) return -4;
  Directions dirs;
  dirs.count = 0;
  for (int i = 0; i < n_rows; ++i) {
    if (rows[i] < 0 || rows[i] >= k_params) return -4;
    dirs.row[dirs.count++] = rows[i];
  }
  if (dgamma != nullptr) dirs.row[dirs.count++] = k_params;
  if (dirs.count == 0) return -4;
  const dim3 grid((batch + kThreads - 1) / kThreads, dirs.count);
  nll_bwd_kernel<S, N, L, Model, Tab><<<grid, kThreads, 0, stream>>>(
      static_cast<const S*>(phys), k_params, batch, static_cast<const S*>(ys), rig, S(gamma_sqrt),
      static_cast<const S*>(g), dirs, static_cast<S*>(dphys), static_cast<S*>(dgamma));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entry of one Kvaerno3 Hodgkin-Huxley instantiation (L = 1).
#define ODEUQ_NLL_BWD_KVAERNO3(NAME, REAL, DIM)                                                   \
  extern "C" int NAME(const void* phys, int k_params, int batch, const void* ys, const double* rig, \
                      double gamma_sqrt, const void* g, const int* rows, int n_rows, void* dphys,   \
                      void* dgamma, void* stream) {                                                 \
    return launch<REAL, 1, HodgkinHuxley<DIM>, Kvaerno3>(phys, k_params, batch, ys, rig,          \
                                                         gamma_sqrt, g, rows, n_rows, dphys,        \
                                                         dgamma, static_cast<cudaStream_t>(stream)); \
  }
