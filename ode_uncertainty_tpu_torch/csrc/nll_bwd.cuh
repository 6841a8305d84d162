// The NLL-gradient kernel templates and their launchers, shared by
// nll_bwd.cu (the dispatcher and the Lotka-Volterra x RKF45
// instantiations, one thread per lane and direction), the nll_bwd_erk_*.cu
// units (a tile model under the explicit tableaus, one thread per lane and
// direction; Hodgkin-Huxley under them, nll_bwd_erk_hh*.cu and
// nll_bwd_dopri65_hh*.cu, a team of threads per lane and direction), the
// nll_bwd_kv3_*.cu units (a tile model under Kvaerno3, a team) and the
// nll_bwd_hh*.cu units, one Kvaerno3 Hodgkin-Huxley instantiation each on a
// team (one model, type and kernel a unit, so that nvcc builds them in
// parallel). See nll_bwd.cu for the design.

#pragma once

#include "dual.cuh"
#include "ekf_chain.cuh"
#include "team_chain.cuh"

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

// The direction list of a launch, or -4: rows[0..n_rows) (distinct
// parameter rows), then gamma^1/2 when with_dgamma.
inline int make_directions(int k_params, const int* rows, int n_rows, bool with_dgamma, Directions* dirs) {
  if (n_rows < 0 || n_rows > k_params || n_rows > kMaxParams) return -4;
  dirs->count = 0;
  for (int i = 0; i < n_rows; ++i) {
    if (rows[i] < 0 || rows[i] >= k_params) return -4;
    dirs->row[dirs->count++] = rows[i];
  }
  if (with_dgamma) dirs->row[dirs->count++] = k_params;
  return dirs->count == 0 ? -4 : 0;
}

// rows[0..n_rows): parameter rows; gamma^1/2 too when dgamma is not null.
template <typename S, int L, class Model, class Tab>
int launch(const void* phys, int k_params, int batch, const void* ys, const double* rig_host,
           double gamma_sqrt, const void* g, const int* rows, int n_rows, void* dphys, void* dgamma,
           cudaStream_t stream) {
  constexpr int N = Model::N;
  const Rig<S, N, L> rig = unpack_rig<S, N, L, Model>(rig_host);
  if (rig.n_obs < 1 || rig.d < 1 || rig.first < 0 || rig.newton_iters < 0) return -3;
  Directions dirs;
  if (const int bad = make_directions(k_params, rows, n_rows, dgamma != nullptr, &dirs)) return bad;
  const dim3 grid((batch + kThreads - 1) / kThreads, dirs.count);
  nll_bwd_kernel<S, N, L, Model, Tab><<<grid, kThreads, 0, stream>>>(
      static_cast<const S*>(phys), k_params, batch, static_cast<const S*>(ys), rig, S(gamma_sqrt),
      static_cast<const S*>(g), dirs, static_cast<S*>(dphys), static_cast<S*>(dgamma));
  return static_cast<int>(cudaGetLastError());
}

// The chain of one (lane, direction) on dual numbers, on a team of
// team_size(n) threads, one warp a block (team_chain.cuh); blockIdx.y
// indexes the direction list.
template <typename S, class Model, int L, class Tab>
__global__ void __launch_bounds__(kWarp)
    nll_bwd_team_kernel(const S* __restrict__ phys, int k_params, int batch, const S* __restrict__ ys,
                        const Rig<S, Model::N, L> rig, const S gamma_sqrt, const S* __restrict__ g,
                        const Directions dirs, S* __restrict__ dphys, S* __restrict__ dgamma) {
  constexpr int N = Model::N, TS = team_size(N);
  using TeamSlab = Slab<Dual<S>, N, TS>;
  __shared__ S slab[kWarp / TS * TeamSlab::kStride];
  const int team = threadIdx.x / TS, c = threadIdx.x % TS;
  const int lane = blockIdx.x * (kWarp / TS) + team;
  const int dir = dirs.row[blockIdx.y];
  const typename Model::template Params<S> p =
      Model::template load<S>(phys, batch, lane < batch ? lane : batch - 1, rig.poff);
  const typename Model::template Params<Dual<S>> pd = seed(p, rig.poff, dir);
  const Dual<S> gs(gamma_sqrt, S(dir == k_params));
  const Dual<S> nll = team_chain_nll<TS, Dual<S>, N, L, Model, Tab>(rig, pd, gs, ys, c, TeamSlab(slab, team));
  if (c != 0 || lane >= batch) return;
  const S out = g[lane] * nll.d;
  if (dir < k_params)
    dphys[static_cast<size_t>(dir) * batch + lane] = out;
  else
    dgamma[lane] = out;
}

template <typename S, class Model, int L, class Tab>
int launch_team(const void* phys, int k_params, int batch, const void* ys, const double* rig_host,
                double gamma_sqrt, const void* g, const int* rows, int n_rows, void* dphys, void* dgamma,
                cudaStream_t stream) {
  constexpr int N = Model::N, lanes_per_block = kWarp / team_size(N);
  const Rig<S, N, L> rig = unpack_rig<S, N, L, Model>(rig_host);
  if (rig.n_obs < 1 || rig.d < 1 || rig.first < 0 || rig.newton_iters < 0) return -3;
  Directions dirs;
  if (const int bad = make_directions(k_params, rows, n_rows, dgamma != nullptr, &dirs)) return bad;
  const dim3 grid((batch + lanes_per_block - 1) / lanes_per_block, dirs.count);
  nll_bwd_team_kernel<S, Model, L, Tab><<<grid, kWarp, 0, stream>>>(
      static_cast<const S*>(phys), k_params, batch, static_cast<const S*>(ys), rig, S(gamma_sqrt),
      static_cast<const S*>(g), dirs, static_cast<S*>(dphys), static_cast<S*>(dgamma));
  return static_cast<int>(cudaGetLastError());
}

// Tab at an observation size L in 1..MaxL, on a thread (Team false) or a
// team of threads (Team true) per (lane, direction); -1 for another size.
template <typename S, class Model, class Tab, bool Team, int MaxL, int L = 1>
int launch_sizes(int obs_dim, const void* phys, int k_params, int batch, const void* ys, const double* rig,
                 double gamma_sqrt, const void* g, const int* rows, int n_rows, void* dphys, void* dgamma,
                 cudaStream_t stream) {
  if (obs_dim == L) {
    if constexpr (Team)
      return launch_team<S, Model, L, Tab>(phys, k_params, batch, ys, rig, gamma_sqrt, g, rows, n_rows, dphys,
                                           dgamma, stream);
    else
      return launch<S, L, Model, Tab>(phys, k_params, batch, ys, rig, gamma_sqrt, g, rows, n_rows, dphys, dgamma,
                                      stream);
  }
  if constexpr (L < MaxL)
    return launch_sizes<S, Model, Tab, Team, MaxL, L + 1>(obs_dim, phys, k_params, batch, ys, rig, gamma_sqrt, g,
                                                          rows, n_rows, dphys, dgamma, stream);
  return -1;
}

// The tableau with id `tableau` (TableauId) among a unit's Tabs; -1 if none.
template <typename S, class Model, bool Team, int MaxL, class... Tabs>
int launch_tableau(int tableau, int obs_dim, const void* phys, int k_params, int batch, const void* ys,
                   const double* rig, double gamma_sqrt, const void* g, const int* rows, int n_rows, void* dphys,
                   void* dgamma, cudaStream_t stream) {
  int err = -1;
  (void)((tableau == TableauId<Tabs>::value
              ? (err = launch_sizes<S, Model, Tabs, Team, MaxL>(obs_dim, phys, k_params, batch, ys, rig,
                                                              gamma_sqrt, g, rows, n_rows, dphys, dgamma, stream),
                 true)
              : false) ||
         ...);
  return err;
}

}  // namespace

// The C entry of a unit of MODEL under the tableaus that follow, in REAL,
// at L = 1..MAX_L, a team of threads per (lane, direction) when TEAM. A
// tableau or size the unit lacks returns -1.
#define ODEUQ_NLL_BWD_UNIT(NAME, REAL, MODEL, TEAM, MAX_L, ...)                                          \
  extern "C" int NAME(int tableau, int obs_dim, const void* phys, int k_params, int batch, const void* ys, \
                      const double* rig, double gamma_sqrt, const void* g, const int* rows, int n_rows,     \
                      void* dphys, void* dgamma, void* stream) {                                            \
    return launch_tableau<REAL, MODEL, TEAM, MAX_L, __VA_ARGS__>(tableau, obs_dim, phys, k_params, batch,   \
                                                                 ys, rig, gamma_sqrt, g, rows, n_rows,     \
                                                                 dphys, dgamma,                            \
                                                                 static_cast<cudaStream_t>(stream));       \
  }
