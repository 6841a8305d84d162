// The forward-NLL kernel templates and their launchers, shared by
// nll_fwd.cu (the dispatcher and the Lotka-Volterra x RKF45
// instantiations, one thread per lane), the nll_fwd_erk_*.cu units (one
// model each under the explicit tableaus, one thread per lane) and the
// nll_fwd_hh*.cu units, one Kvaerno3 Hodgkin-Huxley instantiation each on
// a team of threads per lane (so that nvcc builds them in parallel). See
// nll_fwd.cu for the design.

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

// An explicit tableau of a unit (nll_fwd_erk_*.cu) at L = 1 or, for n > 1,
// L = n; -1 for another observation size.
template <typename T, class Model, class Tab>
int launch_sizes(int obs_dim, const void* phys, int batch, const void* ys, const double* rig, double gamma_sqrt,
                 void* out, cudaStream_t stream) {
  if (obs_dim == 1) return launch<T, 1, Model, Tab>(phys, batch, ys, rig, gamma_sqrt, out, stream);
  if constexpr (Model::N > 1) {
    if (obs_dim == Model::N) return launch<T, Model::N, Model, Tab>(phys, batch, ys, rig, gamma_sqrt, out, stream);
  }
  return -1;
}

// The tableau with id `tableau` (TableauId) among a unit's Tabs; -1 if none.
template <typename T, class Model, class... Tabs>
int launch_erk(int tableau, int obs_dim, const void* phys, int batch, const void* ys, const double* rig,
               double gamma_sqrt, void* out, cudaStream_t stream) {
  int err = -1;
  (void)((tableau == TableauId<Tabs>::value
              ? (err = launch_sizes<T, Model, Tabs>(obs_dim, phys, batch, ys, rig, gamma_sqrt, out, stream), true)
              : false) ||
         ...);
  return err;
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

// The C entry of one explicit-step unit: MODEL under the tableaus that
// follow, in REAL, at L = 1 and (n > 1) L = n.
#define ODEUQ_NLL_FWD_ERK(NAME, REAL, MODEL, ...)                                                    \
  extern "C" int NAME(int tableau, int obs_dim, const void* phys, int batch, const void* ys,        \
                      const double* rig, double gamma_sqrt, void* out, void* stream) {              \
    return launch_erk<REAL, MODEL, __VA_ARGS__>(tableau, obs_dim, phys, batch, ys, rig, gamma_sqrt, \
                                                out, static_cast<cudaStream_t>(stream));           \
  }
