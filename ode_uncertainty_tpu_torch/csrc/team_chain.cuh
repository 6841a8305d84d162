// The square-root EKF chain of one lane, run by a team of threads
// (nll_fwd.cuh and nll_bwd.cuh launch it for the Kvaerno3 units of every
// model and for Hodgkin-Huxley under the explicit tableaus).
//
// A team is n threads rounded up to a power of two (1, 2 and 4 for the tile
// models with n = 1, 2, 3; 4 for reduced-4, 8 for n = 7 and 8) inside one
// warp. Thread c owns column c of the covariance
// square root P and everything that follows that column through a step:
// the column's tangent through every stage, row c of the QR stack
// [P_pred^T; (g Q)^T] and, after the QR, column c of the new P. The
// state x, the stage values k[s] and the Newton iterate z are held by
// every thread of the team; they come out of the same arithmetic on the
// same operands, so the copies agree bit for bit.
//
// The work of a step is split so that no thread holds an n x n matrix of
// working values:
//   * Jacobian: thread c evaluates the RHS once on a jet with one tangent
//     seeded with e_c, which gives k[s] and column c of J (on a dual
//     number a jet of duals: 4 values an entry).
//   * Solves with I - h g J: Gauss-Jordan without pivoting over the team's
//     columns (`team_solve`): at pivot j thread j's column is broadcast by
//     shuffles and row j is scaled by one reciprocal. Thread c's right-hand
//     column becomes its column of (I - h g J)^-1 B, so the stage tangent
//     dz = (I - h g J)^-1 d(known) of its column needs no inverse at all;
//     the base-point inverse for the Newton iterations is the solve with
//     B = I.
//   * Products with a whole matrix (J times a column, the rows of the
//     Newton inverse) read a per-team slab of shared memory that the team
//     fills column by column between two warp barriers.
//   * Newton iterations run on values: every thread evaluates the RHS at the
//     common z, thread i forms row i of minv0 (z - known - h g f) and the
//     update is gathered by n shuffles.
//   * QR (`team_qr`): a Householder sweep over the columns of the 2n x n
//     stack whose rows c and n + c thread c holds. The max-abs scale is a
//     shuffle-xor max over the team; each column's squared norm below the
//     pivot, its products with the later columns and the pivot row itself
//     (which only thread j holds) go through one shuffle-xor sum over the
//     team, so a column step costs log2(team) shuffle rounds.
//   * Correct (L = 1): column c's share of H P, the innovation's 1 x 1 R
//     factor and the gain K = P P^T H^T / s^2 come from sums over the
//     team; the Joseph-form QR reuses `team_qr`, with the K R row in
//     thread 0's second row. With L > 1 observed rows (tile models, n <= 3)
//     the team gathers P in its slab and every thread runs the per-thread
//     correct of ekf_chain.cuh on the same operands (`team_correct_rows`).
//   * An explicit step (Hodgkin-Huxley): every thread evaluates the stage
//     slopes and, in the same jet evaluation, column c's stage tangent
//     (`team_stages_erk`); only the QRs are shared.
// Sums over the team are shuffle-xor butterflies: addition commutes, so
// every thread ends with the same bits. A team with more threads than n
// gives its extra threads zero columns, which add nothing.
//
// The rules of the per-thread chain carry over (ekf_chain.cuh, dual.cuh):
// the stage solve's implicit-function rule on dual numbers (Newton on the
// values, the tangent of z* from the rule, `TeamStageSolution`), the zero
// tangent of sqrt at 0, step times from the index in double, the native
// expm1, and the Newton loop kept a loop. The value of every quantity is
// the per-thread chain's up to the order of the sums.
//
// Every thread of the warp runs the same control flow: a lane past the end
// of the batch runs a copy of the last lane and writes nothing, so that the
// shuffles and warp barriers see the whole warp.

#pragma once

#include "dual.cuh"

namespace {

// the float and double overloads beside dual.cuh's, for the unqualified
// calls below (dual.cuh's templates would hide them)
using ::fabs;
using ::log;

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Threads in the team of an n-state lane: n rounded up to a power of two.
__host__ __device__ constexpr int team_size(int n) { return n <= 1 ? 1 : 2 * team_size((n + 1) / 2); }

// Shuffles inside teams of TS threads (the whole warp takes part).
template <int TS>
__device__ __forceinline__ float team_shfl(float v, int src) {
  return __shfl_sync(kFullMask, v, src, TS);
}
template <int TS>
__device__ __forceinline__ double team_shfl(double v, int src) {
  return __shfl_sync(kFullMask, v, src, TS);
}
template <int TS, typename S>
__device__ __forceinline__ Dual<S> team_shfl(Dual<S> v, int src) {
  return {team_shfl<TS>(v.v, src), team_shfl<TS>(v.d, src)};
}
template <int TS>
__device__ __forceinline__ float team_xor(float v, int mask) {
  return __shfl_xor_sync(kFullMask, v, mask, TS);
}
template <int TS>
__device__ __forceinline__ double team_xor(double v, int mask) {
  return __shfl_xor_sync(kFullMask, v, mask, TS);
}
template <int TS, typename S>
__device__ __forceinline__ Dual<S> team_xor(Dual<S> v, int mask) {
  return {team_xor<TS>(v.v, mask), team_xor<TS>(v.d, mask)};
}

// The first `count` elements of v <- their sums over the team, element by
// element (`count` is a constant once the caller's loops are unrolled).
template <int TS, typename T, int M>
__device__ __forceinline__ void team_sum(T (&v)[M], int count = M) {
#pragma unroll
  for (int m = 1; m < TS; m <<= 1) {
    T other[M];
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i < count) other[i] = team_xor<TS>(v[i], m);
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i < count) v[i] = v[i] + other[i];
  }
}

// Whether o replaces m in a max that propagates NaN. Symmetric, so both
// partners of a butterfly keep the same value (ties of a dual number go to
// the larger tangent).
__device__ __forceinline__ bool takes_over(float o, float m) { return m == m && (o != o || o > m); }
__device__ __forceinline__ bool takes_over(double o, double m) { return m == m && (o != o || o > m); }
template <typename S>
__device__ __forceinline__ bool takes_over(Dual<S> o, Dual<S> m) {
  return m.v == m.v && (o.v != o.v || o.v > m.v || (o.v == m.v && o.d > m.d));
}

template <int TS, typename T>
__device__ __forceinline__ T team_max(T m) {
#pragma unroll
  for (int k = 1; k < TS; k <<= 1) {
    const T o = team_xor<TS>(m, k);
    m = takes_over(o, m) ? o : m;
  }
  return m;
}

// Gauss-Jordan without pivoting over the team's columns (ops/small_inv.py's
// sweep): thread c holds column c of A (a) and of B (b); afterwards b is
// column c of A^-1 B. At pivot j, column j is broadcast from thread j and
// row j is scaled by one reciprocal of the pivot.
template <int TS, typename T, int N>
__device__ __forceinline__ void team_solve(T (&a)[N], T (&b)[N]) {
  using S = typename Scalar<T>::type;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T col[N];
#pragma unroll
    for (int i = 0; i < N; ++i) col[i] = team_shfl<TS>(a[i], j);
    const T inv = div_t(S(1), col[j]);
    const T aj = a[j] * inv, bj = b[j] * inv;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i == j) continue;
      a[i] = a[i] - col[i] * aj;
      b[i] = b[i] - col[i] * bj;
    }
    a[j] = aj;
    b[j] = bj;
  }
}

// f = rhs(t, y) and column c of J = df/dy: the JVP along e_c (rhs_jvp,
// ekf_chain.cuh; a thread past the last column gets a zero column).
template <class Model, typename P, typename T>
__device__ __forceinline__ void column_jacobian(const typename Model::template Params<P>& p,
                                                typename Scalar<T>::type t, const T (&y)[Model::N], int c,
                                                T (&f)[Model::N], T (&col)[Model::N]) {
  using S = typename Scalar<T>::type;
  constexpr int N = Model::N;
  T e[N];
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = T(S(i == c ? 1 : 0));
  rhs_jvp<Model, P, T>(p, t, y, e, f, col);
}

// The per-team slab of shared memory: an n x TS matrix of working values
// (a Jacobian, by columns) and one of values (the Newton inverse). Teams sit
// a few words apart modulo the 32 banks, so that the teams of a warp
// reading the same entry at once do not collide.
template <typename T, int N, int TS>
struct Slab {
  using S = typename Scalar<T>::type;
  static constexpr int kPerS = static_cast<int>(sizeof(T) / sizeof(S));
  static constexpr int kWords = N * TS * (kPerS + 1) * static_cast<int>(sizeof(S)) / 4;
  static constexpr int kStrideWords = (kWords + 31) / 32 * 32 + static_cast<int>(sizeof(S)) / 4;
  static constexpr int kStride = kStrideWords * 4 / static_cast<int>(sizeof(S));  // in S
  T* jac;  // jac[i * TS + k] = J[i][k]
  S* minv;  // minv[i * TS + k] = minv0[i][k]
  __device__ __forceinline__ Slab(S* block_slab, int team)
      : jac(reinterpret_cast<T*>(block_slab + team * kStride)),
        minv(block_slab + team * kStride + N * TS * kPerS) {}
};

// out = J v with J from the slab
template <int TS, typename T, int N>
__device__ __forceinline__ void slab_matvec(const T* m, const T (&v)[N], T (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = m[i * TS] * v[0];
#pragma unroll
    for (int k = 1; k < N; ++k) acc = acc + m[i * TS + k] * v[k];
    out[i] = acc;
  }
}

// The stage solution z* as a working value: z* itself on float and double.
template <typename T>
struct TeamStageSolution {
  template <int TS, class Model, int N>
  __device__ __forceinline__ static void attach(const typename Model::template Params<T>& /*p*/,
                                                const typename Model::template Params<T>& /*pv*/,
                                                T /*ts*/, T /*hg*/, const T (&/*known*/)[N],
                                                const T (&z)[N], int /*c*/, T (&out)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = z[i];
  }
};

// On dual numbers the tangent of z* follows the stage solve's
// implicit-function rule (pallas_ekf.py:312-332): dz = M^-1 dG with
// M = I - h g J(z*) on the values and dG = d(known) + h g (df/dp) dp, the
// RHS on duals with z's tangent zero. The team solves M dz = dG with every
// thread holding the same dG, so every thread gets the same dz.
template <typename S>
struct TeamStageSolution<Dual<S>> {
  template <int TS, class Model, int N>
  __device__ __forceinline__ static void attach(const typename Model::template Params<Dual<S>>& p,
                                                const typename Model::template Params<S>& pv, S ts,
                                                S hg, const Dual<S> (&known)[N], const S (&z)[N], int c,
                                                Dual<S> (&out)[N]) {
    S f[N], jcol[N], m[N];
    column_jacobian<Model, S, S>(pv, ts, z, c, f, jcol);
#pragma unroll
    for (int i = 0; i < N; ++i) m[i] = S(i == c ? 1 : 0) - hg * jcol[i];
    Dual<S> zd[N], fd[N];
#pragma unroll
    for (int i = 0; i < N; ++i) zd[i] = Dual<S>(z[i]);
    Model::rhs(p, ts, zd, fd);
    S dz[N];
#pragma unroll
    for (int i = 0; i < N; ++i) dz[i] = known[i].d + hg * fd[i].d;
    team_solve<TS, S, N>(m, dz);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = Dual<S>(z[i], dz[i]);
  }
};

// R factor of the thin QR of the 2n x n stack whose rows c and n + c thread
// c holds (a0, a1): Householder with max-abs scaling and the (4 eps)^2
// zero-column guard (ops/small_qr.py, ekf_chain.cuh `qr_r`). Afterwards a0
// holds row c of R (rows past n: zero).
template <int TS, typename T, int N>
__device__ __forceinline__ void team_qr(int c, T (&a0)[N], T (&a1)[N]) {
  using S = typename Scalar<T>::type;
  const S e4 = S(4) * machine_eps<S>();
  const S eps = e4 * e4;
  T m = fabs(a0[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) m = nan_max(m, T(fabs(a0[k])));
#pragma unroll
  for (int k = 0; k < N; ++k) m = nan_max(m, T(fabs(a1[k])));
  m = team_max<TS>(m);
  const T scale = m > S(0) ? m : T(1);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    a0[k] = div_t(a0[k], scale);
    a1[k] = div_t(a1[k], scale);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int w = N - j;  // columns j..n-1
    // part[0]: the sum below the pivot of a[i][j]^2; part[k - j], k > j:
    // of a[i][j] a[i][k]; part[w + k - j]: the pivot row's entry k (thread j's)
    T part[2 * N];
    const bool below = c > j;
    part[0] = (below ? a0[j] * a0[j] : T(0)) + a1[j] * a1[j];
#pragma unroll
    for (int k = j + 1; k < N; ++k) part[k - j] = (below ? a0[j] * a0[k] : T(0)) + a1[j] * a1[k];
#pragma unroll
    for (int k = j; k < N; ++k) part[w + k - j] = c == j ? a0[k] : T(0);
    team_sum<TS>(part, 2 * w);
    const T col0 = part[w];
    const T sigma = sqrt_t(col0 * col0 + part[0]);
    const S sign = col0 >= S(0) ? S(1) : S(-1);
    const T alpha = -sign * sigma;
    const T v0 = col0 + sigma * sign;
    const T vnorm_sq = v0 * v0 + part[0];
    const bool live = vnorm_sq > eps;
    const T inv = live ? div_t(S(2), vnorm_sq) : T(0);
    const T lead_row = c == j ? v0 : a0[j];
#pragma unroll
    for (int k = j + 1; k < N; ++k) {
      const T coeff = (v0 * part[w + k - j] + part[k - j]) * inv;
      const T upd = a0[k] - lead_row * coeff;
      a0[k] = c >= j ? upd : a0[k];
      a1[k] = a1[k] - a1[j] * coeff;
    }
    a0[j] = c == j ? (live ? alpha : col0) : below ? T(0) : a0[j];
    a1[j] = T(0);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) a0[k] = a0[k] * scale;
}

// The stages of the Kvaerno3 step (pallas_ekf.py:291-364) for thread c of
// the team: k[s] the lane's stage slopes, dk[s] column c's tangent of stage
// s, from x, the lane's state, and pc, column c of P. The base-point
// inverse minv0 = (I - h g J0)^-1 only speeds up the Newton iterations and
// carries no tangent.
template <int TS, typename T, int N, int L, class Model>
__device__ __forceinline__ void team_stages_kvaerno3(const Rig<typename Scalar<T>::type, N, L>& rig,
                                                     const typename Model::template Params<T>& p,
                                                     const typename Model::template Params<typename Scalar<T>::type>& pv,
                                                     typename Scalar<T>::type t, int c, const Slab<T, N, TS>& slab,
                                                     const T (&x)[N], const T (&pc)[N], T (&k)[Kvaerno3::S][N],
                                                     T (&dk)[Kvaerno3::S][N]) {
  using S = typename Scalar<T>::type;
  const S hg = S(rig.h * Kvaerno3::kGamma);
  T jcol[N];
  column_jacobian<Model, T, T>(p, t, x, c, k[0], jcol);
  S mrow[N];  // row c of minv0
  {
    S a[N], b[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      a[i] = S(i == c ? 1 : 0) - hg * value_of(jcol[i]);
      b[i] = S(i == c ? 1 : 0);
    }
    team_solve<TS, S, N>(a, b);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      slab.jac[i * TS + c] = jcol[i];
      slab.minv[i * TS + c] = b[i];
    }
    __syncwarp();
    const int row = c < N ? c : N - 1;
#pragma unroll
    for (int j = 0; j < N; ++j) mrow[j] = c < N ? slab.minv[row * TS + j] : S(0);
    slab_matvec<TS, T, N>(slab.jac, pc, dk[0]);
  }
#pragma unroll
  for (int s = 1; s < Kvaerno3::S; ++s) {
    const S ts = t + S(Kvaerno3::c(s) * rig.h);
    T known[N], dknown[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      known[i] = x[i];
      dknown[i] = pc[i];
    }
#pragma unroll
    for (int j = 0; j < s; ++j) {
      const S ha = S(rig.h * Kvaerno3::a(s, j));
#pragma unroll
      for (int i = 0; i < N; ++i) {
        known[i] = known[i] + ha * k[j][i];
        dknown[i] = dknown[i] + ha * dk[j][i];
      }
    }
    S z[N], kv[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      kv[i] = value_of(known[i]);
      z[i] = kv[i] + hg * value_of(k[s - 1][i]);
    }
    // a loop, not unrolled (the iterations are serial anyway)
#pragma unroll 1
    for (int it = 0; it < rig.newton_iters; ++it) {
      S f[N];
      Model::rhs(pv, ts, z, f);
      S upd = S(0);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const S r = z[j] - kv[j] - hg * f[j];
        upd = j == 0 ? mrow[0] * r : upd + mrow[j] * r;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) z[i] = z[i] - team_shfl<TS>(upd, i);
    }
    T zs[N];
    TeamStageSolution<T>::template attach<TS, Model, N>(p, pv, ts, hg, known, z, c, zs);
    column_jacobian<Model, T, T>(p, ts, zs, c, k[s], jcol);
    T a[N];
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = S(i == c ? 1 : 0) - hg * jcol[i];
    team_solve<TS, T, N>(a, dknown);  // dknown <- (I - h g J)^-1 dknown
    __syncwarp();
#pragma unroll
    for (int i = 0; i < N; ++i) slab.jac[i * TS + c] = jcol[i];
    __syncwarp();
    slab_matvec<TS, T, N>(slab.jac, dknown, dk[s]);
  }
}

// The stages of an explicit step (pallas_ekf.py:171) for thread c of the
// team: every thread evaluates the lane's stage slopes k[s] and column c's
// tangent dk[s] in one rhs_jvp along that column's stage tangent, so the
// team shares no matrix.
template <typename T, int N, int L, class Model, class Tab>
__device__ __forceinline__ void team_stages_erk(const Rig<typename Scalar<T>::type, N, L>& rig,
                                                const typename Model::template Params<T>& p,
                                                typename Scalar<T>::type t, const T (&x)[N], const T (&pc)[N],
                                                T (&k)[Tab::S][N], T (&dk)[Tab::S][N]) {
  using S = typename Scalar<T>::type;
#pragma unroll
  for (int s = 0; s < Tab::S; ++s) {
    T y[N], dy[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      y[i] = x[i];
      dy[i] = pc[i];
    }
#pragma unroll
    for (int j = 0; j < s; ++j) {
      if (Tab::a(s, j) != 0.0) {
        const S ha = S(rig.h * Tab::a(s, j));
#pragma unroll
        for (int i = 0; i < N; ++i) {
          y[i] = y[i] + ha * k[j][i];
          dy[i] = dy[i] + ha * dk[j][i];
        }
      }
    }
    rhs_jvp<Model, T, T>(p, t + S(Tab::c(s) * rig.h), y, dy, k[s], dk[s]);
  }
}

// One EKF predict (pallas_ekf.py:480-497) with the step Tab for thread c of
// the team: x is the lane's state, pc column c of P, qc column c of g Q.
template <int TS, typename T, int N, int L, class Model, class Tab>
__device__ __forceinline__ void team_predict(const Rig<typename Scalar<T>::type, N, L>& rig,
                                             const typename Model::template Params<T>& p,
                                             const typename Model::template Params<typename Scalar<T>::type>& pv,
                                             const T (&qc)[N], typename Scalar<T>::type t, int c,
                                             const Slab<T, N, TS>& slab, T (&x)[N], T (&pc)[N]) {
  using S = typename Scalar<T>::type;
  T k[Tab::S][N], dk[Tab::S][N];  // dk[s]: column c's tangent of stage s
  if constexpr (Tab::kImplicit)
    team_stages_kvaerno3<TS, T, N, L, Model>(rig, p, pv, t, c, slab, x, pc, k, dk);
  else
    team_stages_erk<T, N, L, Model, Tab>(rig, p, t, x, pc, k, dk);
  // rows c and n + c of the QR stack: column c of P_pred, column c of g Q
  T a0[N], a1[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a0[i] = pc[i];
    a1[i] = qc[i];
  }
#pragma unroll
  for (int s = 0; s < Tab::S; ++s) {
    if (Tab::b(s) != 0.0) {
      const S hb = S(rig.h * Tab::b(s));
#pragma unroll
      for (int i = 0; i < N; ++i) {
        x[i] = x[i] + hb * k[s][i];
        a0[i] = a0[i] + hb * dk[s][i];
      }
    }
  }
  team_qr<TS, T, N>(c, a0, a1);
#pragma unroll
  for (int i = 0; i < N; ++i) pc[i] = a0[i];
}

// Joseph-form correct with one observed row (L = 1) for thread c; returns
// the innovation NLL (the same in every thread).
template <int TS, typename T, int N>
__device__ __forceinline__ T team_correct(const Rig<typename Scalar<T>::type, N, 1>& rig, int c, T (&x)[N],
                                          T (&pc)[N], typename Scalar<T>::type y) {
  using S = typename Scalar<T>::type;
  T y_hat = T(0), hp = T(0);  // H x, and H P's entry c
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (rig.H[0][k] != S(0)) {
      y_hat = y_hat + rig.H[0][k] * x[k];
      hp = hp + rig.H[0][k] * pc[k];
    }
  }
  // s: the R factor of [(H P)^T; R^T], rows c (thread c) and n (thread 0)
  const T r0 = T(rig.R[0][0]);
  T s;
  {
    const S e4 = S(4) * machine_eps<S>();
    const S eps = e4 * e4;
    T m = fabs(hp);
    if (c == 0) m = nan_max(m, T(fabs(r0)));
    m = team_max<TS>(m);
    const T scale = m > S(0) ? m : T(1);
    const T e0 = div_t(hp, scale);
    const T e1 = c == 0 ? div_t(r0, scale) : T(0);
    T part[2] = {c == 0 ? e0 : T(0), (c > 0 ? e0 * e0 : T(0)) + e1 * e1};
    team_sum<TS>(part);
    const T col0 = part[0];
    const T sigma = sqrt_t(col0 * col0 + part[1]);
    const S sign = col0 >= S(0) ? S(1) : S(-1);
    const T alpha = -sign * sigma;
    const T v0 = col0 + sigma * sign;
    const T vnorm_sq = v0 * v0 + part[1];
    s = (vnorm_sq > eps ? alpha : col0) * scale;
  }
  // K = P P^T H^T / s^2: w_c = (H / s / s) . P[:, c], K = sum_c w_c P[:, c]
  T w = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (rig.H[0][k] != S(0)) w = w + div_t(div_t(T(rig.H[0][k]), s), s) * pc[k];
  T kg[N];
#pragma unroll
  for (int i = 0; i < N; ++i) kg[i] = w * pc[i];
  team_sum<TS>(kg);
  const T innov = y - y_hat;
  // Joseph form: rows [((I - K H) P)^T; (K R)^T], row c and (thread 0) K R
  T a0[N], a1[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const T kh = rig.H[0][k] != S(0) ? kg[i] * rig.H[0][k] : T(0);
      acc = acc + (S(i == k ? 1 : 0) - kh) * pc[k];
    }
    a0[i] = acc;
    const T kr = rig.R[0][0] != S(0) ? kg[i] * rig.R[0][0] : T(0);
    a1[i] = c == 0 ? kr : T(0);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = x[i] + kg[i] * innov;
  team_qr<TS, T, N>(c, a0, a1);
#pragma unroll
  for (int i = 0; i < N; ++i) pc[i] = a0[i];
  const T z = div_t(innov, s);
  return (S(0.5) * (z * z) + rig.nll_const) + log(fabs(s));
}

// Joseph-form correct with L observed rows (L > 1) for thread c: the team
// gathers P in its slab, every thread runs the per-thread correct
// (ekf_chain.cuh `correct`) on the same operands, so x and the NLL agree bit
// for bit across the team, and keeps its own column of the new P.
template <int TS, typename T, int N, int L>
__device__ __forceinline__ T team_correct_rows(const Rig<typename Scalar<T>::type, N, L>& rig, int c,
                                               const Slab<T, N, TS>& slab, T (&x)[N], T (&pc)[N],
                                               const typename Scalar<T>::type* __restrict__ y) {
  __syncwarp();
#pragma unroll
  for (int i = 0; i < N; ++i) slab.jac[i * TS + c] = pc[i];
  __syncwarp();
  T P[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) P[i][j] = slab.jac[i * TS + j];
  const T nll = correct<T, N, L>(rig, x, P, y);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T v = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) v = c == j ? P[i][j] : v;
    pc[i] = v;
  }
  return nll;
}

template <int TS, typename T, int N, int L>
__device__ __forceinline__ T team_correct_any(const Rig<typename Scalar<T>::type, N, L>& rig, int c,
                                              const Slab<T, N, TS>& slab, T (&x)[N], T (&pc)[N],
                                              const typename Scalar<T>::type* __restrict__ y) {
  if constexpr (L == 1)
    return team_correct<TS, T, N>(rig, c, x, pc, y[0]);
  else
    return team_correct_rows<TS, T, N, L>(rig, c, slab, x, pc, y);
}

// The NLL of one lane, by its team (see chain_nll in ekf_chain.cuh for the
// grid and the time rules); every thread of the team returns it.
template <int TS, typename T, int N, int L, class Model, class Tab>
__device__ __forceinline__ T team_chain_nll(const Rig<typename Scalar<T>::type, N, L>& rig,
                                            const typename Model::template Params<T>& p, const T& gamma_sqrt,
                                            const typename Scalar<T>::type* __restrict__ ys, int c,
                                            const Slab<T, N, TS>& slab) {
  using S = typename Scalar<T>::type;
  const typename Model::template Params<S> pv = value_params(p);
  T x[N], pc[N], qc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = T(rig.x0[i]);
    pc[i] = T(0);
    qc[i] = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      pc[i] = c == j ? T(rig.p0[i][j]) : pc[i];
      qc[i] = c == j ? gamma_sqrt * rig.Q[i][j] : qc[i];
    }
  }
  const S t0 = S(rig.t0), h = S(rig.h);
  S t_acc = t0;
  for (int i = 0; i <= rig.first; ++i) {
    const S t = rig.accumulate_time ? t_acc : t0 + S(static_cast<double>(i) * rig.h);
    team_predict<TS, T, N, L, Model, Tab>(rig, p, pv, qc, t, c, slab, x, pc);
    t_acc = t_acc + h;
  }
  T nll = team_correct_any<TS, T, N, L>(rig, c, slab, x, pc, ys);
  for (int j = 1; j < rig.n_obs; ++j) {
    const S tj = S(rig.t0 + static_cast<double>(rig.first + 1 + (j - 1) * rig.d) * rig.h);
    for (int i = 0; i < rig.d; ++i) {
      const S t = rig.accumulate_time ? t_acc : tj + S(static_cast<double>(i) * rig.h);
      team_predict<TS, T, N, L, Model, Tab>(rig, p, pv, qc, t, c, slab, x, pc);
      t_acc = t_acc + h;
    }
    nll = nll + team_correct_any<TS, T, N, L>(rig, c, slab, x, pc, ys + static_cast<size_t>(j) * L);
  }
  return nll;
}

}  // namespace
