// The NLL-gradient kernel templates and their launchers, shared by
// nll_bwd.cu (the dispatcher and the Lotka-Volterra x RKF45
// instantiations, one thread per lane and direction), the nll_bwd_erk_*.cu
// units (one model each under the explicit tableaus, one thread per lane
// and direction) and the nll_bwd_hh*.cu units, one Kvaerno3 Hodgkin-Huxley
// instantiation each on a team of threads per lane and direction (so that
// nvcc builds them in parallel). See nll_bwd.cu for the design.

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

// An explicit tableau of a unit (nll_bwd_erk_*.cu) at L = 1 or, for n > 1,
// L = n; -1 for another observation size.
template <typename S, class Model, class Tab>
int launch_sizes(int obs_dim, const void* phys, int k_params, int batch, const void* ys, const double* rig,
                 double gamma_sqrt, const void* g, const int* rows, int n_rows, void* dphys, void* dgamma,
                 cudaStream_t stream) {
  if (obs_dim == 1)
    return launch<S, 1, Model, Tab>(phys, k_params, batch, ys, rig, gamma_sqrt, g, rows, n_rows, dphys, dgamma,
                                    stream);
  if constexpr (Model::N > 1) {
    if (obs_dim == Model::N)
      return launch<S, Model::N, Model, Tab>(phys, k_params, batch, ys, rig, gamma_sqrt, g, rows, n_rows, dphys,
                                             dgamma, stream);
  }
  return -1;
}

// The tableau with id `tableau` (TableauId) among a unit's Tabs; -1 if none.
template <typename S, class Model, class... Tabs>
int launch_erk(int tableau, int obs_dim, const void* phys, int k_params, int batch, const void* ys,
               const double* rig, double gamma_sqrt, const void* g, const int* rows, int n_rows, void* dphys,
               void* dgamma, cudaStream_t stream) {
  int err = -1;
  (void)((tableau == TableauId<Tabs>::value
              ? (err = launch_sizes<S, Model, Tabs>(obs_dim, phys, k_params, batch, ys, rig, gamma_sqrt, g, rows,
                                                    n_rows, dphys, dgamma, stream),
                 true)
              : false) ||
         ...);
  return err;
}

// The Kvaerno3 chain with L = 1 on dual numbers, one team of team_size(n)
// threads per (lane, direction), one warp a block (team_chain.cuh);
// blockIdx.y indexes the direction list.
template <typename S, class Model>
__global__ void __launch_bounds__(kWarp)
    nll_bwd_team_kernel(const S* __restrict__ phys, int k_params, int batch, const S* __restrict__ ys,
                        const Rig<S, Model::N, 1> rig, const S gamma_sqrt, const S* __restrict__ g,
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
  const Dual<S> nll = team_chain_nll<TS, Dual<S>, N, Model>(rig, pd, gs, ys, c, TeamSlab(slab, team));
  if (c != 0 || lane >= batch) return;
  const S out = g[lane] * nll.d;
  if (dir < k_params)
    dphys[static_cast<size_t>(dir) * batch + lane] = out;
  else
    dgamma[lane] = out;
}

template <typename S, class Model>
int launch_team(const void* phys, int k_params, int batch, const void* ys, const double* rig_host,
                double gamma_sqrt, const void* g, const int* rows, int n_rows, void* dphys, void* dgamma,
                cudaStream_t stream) {
  constexpr int N = Model::N, lanes_per_block = kWarp / team_size(N);
  const Rig<S, N, 1> rig = unpack_rig<S, N, 1, Model>(rig_host);
  if (rig.n_obs < 1 || rig.d < 1 || rig.first < 0 || rig.newton_iters < 0) return -3;
  Directions dirs;
  if (const int bad = make_directions(k_params, rows, n_rows, dgamma != nullptr, &dirs)) return bad;
  const dim3 grid((batch + lanes_per_block - 1) / lanes_per_block, dirs.count);
  nll_bwd_team_kernel<S, Model><<<grid, kWarp, 0, stream>>>(
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
    return launch_team<REAL, HodgkinHuxley<DIM>>(phys, k_params, batch, ys, rig, gamma_sqrt, g,  \
                                                 rows, n_rows, dphys, dgamma,                     \
                                                 static_cast<cudaStream_t>(stream));              \
  }

// The C entry of one explicit-step unit: MODEL under the tableaus that
// follow, in REAL, at L = 1 and (n > 1) L = n.
#define ODEUQ_NLL_BWD_ERK(NAME, REAL, MODEL, ...)                                                        \
  extern "C" int NAME(int tableau, int obs_dim, const void* phys, int k_params, int batch, const void* ys, \
                      const double* rig, double gamma_sqrt, const void* g, const int* rows, int n_rows,     \
                      void* dphys, void* dgamma, void* stream) {                                            \
    return launch_erk<REAL, MODEL, __VA_ARGS__>(tableau, obs_dim, phys, k_params, batch, ys, rig,          \
                                                gamma_sqrt, g, rows, n_rows, dphys, dgamma,                \
                                                static_cast<cudaStream_t>(stream));                       \
  }
