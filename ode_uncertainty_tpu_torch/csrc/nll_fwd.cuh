// The forward-NLL kernel templates and their launchers, shared by
// nll_fwd.cu (the dispatcher and the Lotka-Volterra instantiations, one
// thread per lane) and the nll_fwd_hh*.cu units, one Kvaerno3
// Hodgkin-Huxley instantiation each on a team of threads per lane (so that
// nvcc builds them in parallel). See nll_fwd.cu for the design.

#pragma once

#include "ekf_chain.cuh"
#include "team_chain.cuh"

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
  if (rig.n_obs < 1 || rig.d < 1 || rig.first < 0 || rig.newton_iters < 0) return -3;
  const int blocks = (batch + kThreads - 1) / kThreads;
  nll_fwd_kernel<T, N, L, Model, Tab><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(phys), batch, static_cast<const T*>(ys), rig, T(gamma_sqrt),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The Kvaerno3 chain with L = 1 on one team of team_size(n) threads per
// lane, one warp a block (team_chain.cuh).
template <typename T, class Model>
__global__ void __launch_bounds__(kWarp)
    nll_fwd_team_kernel(const T* __restrict__ phys, int batch, const T* __restrict__ ys,
                        const Rig<T, Model::N, 1> rig, const T gamma_sqrt, T* __restrict__ out) {
  constexpr int N = Model::N, TS = team_size(N);
  using TeamSlab = Slab<T, N, TS>;
  __shared__ T slab[kWarp / TS * TeamSlab::kStride];
  const int team = threadIdx.x / TS, c = threadIdx.x % TS;
  const int lane = blockIdx.x * (kWarp / TS) + team;
  const typename Model::template Params<T> p =
      Model::template load<T>(phys, batch, lane < batch ? lane : batch - 1, rig.poff);
  const T nll = team_chain_nll<TS, T, N, Model>(rig, p, gamma_sqrt, ys, c, TeamSlab(slab, team));
  if (c == 0 && lane < batch) out[lane] = nll;
}

template <typename T, class Model>
int launch_team(const void* phys, int batch, const void* ys, const double* rig_host, double gamma_sqrt,
                void* out, cudaStream_t stream) {
  constexpr int N = Model::N, lanes_per_block = kWarp / team_size(N);
  const Rig<T, N, 1> rig = unpack_rig<T, N, 1, Model>(rig_host);
  if (rig.n_obs < 1 || rig.d < 1 || rig.first < 0 || rig.newton_iters < 0) return -3;
  const int blocks = (batch + lanes_per_block - 1) / lanes_per_block;
  nll_fwd_team_kernel<T, Model><<<blocks, kWarp, 0, stream>>>(
      static_cast<const T*>(phys), batch, static_cast<const T*>(ys), rig, T(gamma_sqrt), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entry of one Kvaerno3 Hodgkin-Huxley instantiation (L = 1).
#define ODEUQ_NLL_FWD_KVAERNO3(NAME, REAL, DIM)                                                \
  extern "C" int NAME(const void* phys, int batch, const void* ys, const double* rig,        \
                      double gamma_sqrt, void* out, void* stream) {                           \
    return launch_team<REAL, HodgkinHuxley<DIM>>(phys, batch, ys, rig, gamma_sqrt, out,      \
                                                 static_cast<cudaStream_t>(stream));         \
  }
