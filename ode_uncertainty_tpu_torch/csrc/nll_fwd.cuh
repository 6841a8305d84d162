// The forward-NLL kernel templates and their launchers, shared by
// nll_fwd.cu (the dispatcher and the Lotka-Volterra x RKF45
// instantiations, one thread per lane), the nll_fwd_erk_*.cu units (a tile
// model under the explicit tableaus, one thread per lane; Hodgkin-Huxley
// under them, nll_fwd_erk_hh*.cu, a team of threads per lane), the
// nll_fwd_kv3_*.cu units (a tile model under Kvaerno3, a team per lane) and
// the nll_fwd_hh*.cu units, one Kvaerno3 Hodgkin-Huxley instantiation each on
// a team per lane (one model, type and kernel a unit, so that nvcc builds
// them in parallel). See nll_fwd.cu for the design.

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

// The chain of one lane on a team of team_size(n) threads, one warp a block
// (team_chain.cuh).
template <typename T, class Model, int L, class Tab>
__global__ void __launch_bounds__(kWarp)
    nll_fwd_team_kernel(const T* __restrict__ phys, int batch, const T* __restrict__ ys,
                        const Rig<T, Model::N, L> rig, const T gamma_sqrt, T* __restrict__ out) {
  constexpr int N = Model::N, TS = team_size(N);
  using TeamSlab = Slab<T, N, TS>;
  __shared__ T slab[kWarp / TS * TeamSlab::kStride];
  const int team = threadIdx.x / TS, c = threadIdx.x % TS;
  const int lane = blockIdx.x * (kWarp / TS) + team;
  const typename Model::template Params<T> p =
      Model::template load<T>(phys, batch, lane < batch ? lane : batch - 1, rig.poff);
  const T nll = team_chain_nll<TS, T, N, L, Model, Tab>(rig, p, gamma_sqrt, ys, c, TeamSlab(slab, team));
  if (c == 0 && lane < batch) out[lane] = nll;
}

template <typename T, class Model, int L, class Tab>
int launch_team(const void* phys, int batch, const void* ys, const double* rig_host, double gamma_sqrt,
                void* out, cudaStream_t stream) {
  constexpr int N = Model::N, lanes_per_block = kWarp / team_size(N);
  const Rig<T, N, L> rig = unpack_rig<T, N, L, Model>(rig_host);
  if (rig.n_obs < 1 || rig.d < 1 || rig.first < 0 || rig.newton_iters < 0) return -3;
  const int blocks = (batch + lanes_per_block - 1) / lanes_per_block;
  nll_fwd_team_kernel<T, Model, L, Tab><<<blocks, kWarp, 0, stream>>>(
      static_cast<const T*>(phys), batch, static_cast<const T*>(ys), rig, T(gamma_sqrt), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Tab at an observation size L in 1..MaxL, on a thread (Team false) or a
// team of threads (Team true) per lane; -1 for another size.
template <typename T, class Model, class Tab, bool Team, int MaxL, int L = 1>
int launch_sizes(int obs_dim, const void* phys, int batch, const void* ys, const double* rig, double gamma_sqrt,
                 void* out, cudaStream_t stream) {
  if (obs_dim == L) {
    if constexpr (Team)
      return launch_team<T, Model, L, Tab>(phys, batch, ys, rig, gamma_sqrt, out, stream);
    else
      return launch<T, L, Model, Tab>(phys, batch, ys, rig, gamma_sqrt, out, stream);
  }
  if constexpr (L < MaxL)
    return launch_sizes<T, Model, Tab, Team, MaxL, L + 1>(obs_dim, phys, batch, ys, rig, gamma_sqrt, out, stream);
  return -1;
}

// The tableau with id `tableau` (TableauId) among a unit's Tabs; -1 if none.
template <typename T, class Model, bool Team, int MaxL, class... Tabs>
int launch_tableau(int tableau, int obs_dim, const void* phys, int batch, const void* ys, const double* rig,
                   double gamma_sqrt, void* out, cudaStream_t stream) {
  int err = -1;
  (void)((tableau == TableauId<Tabs>::value
              ? (err = launch_sizes<T, Model, Tabs, Team, MaxL>(obs_dim, phys, batch, ys, rig, gamma_sqrt, out,
                                                              stream),
                 true)
              : false) ||
         ...);
  return err;
}

}  // namespace

// The C entry of a unit of MODEL under the tableaus that follow, in REAL,
// at L = 1..MAX_L, a team of threads per lane when TEAM. A tableau or size
// the unit lacks returns -1.
#define ODEUQ_NLL_FWD_UNIT(NAME, REAL, MODEL, TEAM, MAX_L, ...)                                      \
  extern "C" int NAME(int tableau, int obs_dim, const void* phys, int batch, const void* ys,        \
                      const double* rig, double gamma_sqrt, void* out, void* stream) {              \
    return launch_tableau<REAL, MODEL, TEAM, MAX_L, __VA_ARGS__>(tableau, obs_dim, phys, batch, ys, rig, \
                                                                 gamma_sqrt, out,                   \
                                                                 static_cast<cudaStream_t>(stream)); \
  }
