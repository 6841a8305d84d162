// A forward-mode dual number for the chain math of ekf_chain.cuh: the value
// and one tangent, with the operations that math uses. Comparisons act on
// the value; |v| has the tangent sign(v) dv with sign(0) = 0, as in PyTorch
// and JAX; quotients and square roots, tangents included, go through the
// branch-free div_t and sqrt_t. Instantiating the chain on Dual<S> gives
// the NLL and its exact derivative along the seeded direction
// (nll_bwd.cuh). For the pendulum it has sin_t and cos_t; for the
// Hodgkin-Huxley rate laws exp_t and expm1_t and the operations of a jet
// of duals (Jet<Dual<S>, 1>, a Jacobian column with its derivative) with
// constants of type S;
// team_chain.cuh gives the Kvaerno3 stage solution's tangent.

#pragma once

#include "ekf_chain.cuh"

namespace {

// A value and one tangent.
template <typename S>
struct Dual {
  S v, d;
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(S value) : v(value), d(S(0)) {}
  __device__ __forceinline__ Dual(S value, S tangent) : v(value), d(tangent) {}
};

template <typename S>
struct Scalar<Dual<S>> {
  using type = S;
};

template <typename S>
__device__ __forceinline__ Dual<S> operator-(Dual<S> a) {
  return {-a.v, -a.d};
}
template <typename S>
__device__ __forceinline__ Dual<S> operator+(Dual<S> a, Dual<S> b) {
  return {a.v + b.v, a.d + b.d};
}
template <typename S>
__device__ __forceinline__ Dual<S> operator+(Dual<S> a, S b) {
  return {a.v + b, a.d};
}
template <typename S>
__device__ __forceinline__ Dual<S> operator+(S a, Dual<S> b) {
  return {a + b.v, b.d};
}
template <typename S>
__device__ __forceinline__ Dual<S> operator-(Dual<S> a, Dual<S> b) {
  return {a.v - b.v, a.d - b.d};
}
template <typename S>
__device__ __forceinline__ Dual<S> operator-(Dual<S> a, S b) {
  return {a.v - b, a.d};
}
template <typename S>
__device__ __forceinline__ Dual<S> operator-(S a, Dual<S> b) {
  return {a - b.v, -b.d};
}
template <typename S>
__device__ __forceinline__ Dual<S> operator*(Dual<S> a, Dual<S> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename S>
__device__ __forceinline__ Dual<S> operator*(Dual<S> a, S b) {
  return {a.v * b, a.d * b};
}
template <typename S>
__device__ __forceinline__ Dual<S> operator*(S a, Dual<S> b) {
  return {a * b.v, a * b.d};
}
// Quotients by the branch-free div_t of ekf_chain.cuh, with the tangent
// rule d(a/b) = (da - (a/b) db) / b; the chains divide through div_t only.
template <typename S>
__device__ __forceinline__ Dual<S> div_t(Dual<S> a, Dual<S> b) {
  const S q = div_t(a.v, b.v);
  return {q, div_t(a.d - q * b.d, b.v)};
}
template <typename S>
__device__ __forceinline__ Dual<S> div_t(Dual<S> a, S b) {
  return {div_t(a.v, b), div_t(a.d, b)};
}
template <typename S>
__device__ __forceinline__ Dual<S> div_t(S a, Dual<S> b) {
  const S q = div_t(a, b.v);
  return {q, div_t(-(q * b.d), b.v)};
}
template <typename S>
__device__ __forceinline__ Dual<S> exp_t(Dual<S> a) {
  const S e = exp_t(a.v);
  return {e, e * a.d};
}
template <typename S>
__device__ __forceinline__ Dual<S> expm1_t(Dual<S> a) {
  const S e = expm1_t(a.v);
  return {e, (e + S(1)) * a.d};
}
// sin and cos with their tangents, from one sincos of the value
__device__ __forceinline__ void sincos_t(float x, float* s, float* c) { ::sincosf(x, s, c); }
__device__ __forceinline__ void sincos_t(double x, double* s, double* c) { ::sincos(x, s, c); }
template <typename S>
__device__ __forceinline__ Dual<S> sin_t(Dual<S> a) {
  S s, c;
  sincos_t(a.v, &s, &c);
  return {s, c * a.d};
}
template <typename S>
__device__ __forceinline__ Dual<S> cos_t(Dual<S> a) {
  S s, c;
  sincos_t(a.v, &s, &c);
  return {c, -(s * a.d)};
}
template <typename S>
__device__ __forceinline__ S value_of(Dual<S> a) {
  return a.v;
}
// At 0 (a QR column that is exactly zero, which float32 reaches when the
// covariance underflows at gamma = 0) the tangent is 0, not 0/0: that
// column's reflection is skipped (`live` false), and without it the NaN
// of the unused reflector would reach every entry through a product with 0.
template <typename S>
__device__ __forceinline__ Dual<S> sqrt_t(Dual<S> a) {
  const S r = sqrt_t(a.v);
  return {r, a.v > S(0) ? div_t(a.d, S(2) * r) : S(0)};
}
template <typename S>
__device__ __forceinline__ Dual<S> log(Dual<S> a) {
  return {::log(a.v), div_t(a.d, a.v)};
}
template <typename S>
__device__ __forceinline__ Dual<S> fabs(Dual<S> a) {
  return {::fabs(a.v), a.v > S(0) ? a.d : a.v < S(0) ? -a.d : S(0)};
}
// comparisons act on the value
template <typename S>
__device__ __forceinline__ bool operator>(Dual<S> a, Dual<S> b) {
  return a.v > b.v;
}
template <typename S>
__device__ __forceinline__ bool operator>(Dual<S> a, S b) {
  return a.v > b;
}
template <typename S>
__device__ __forceinline__ bool operator>=(Dual<S> a, S b) {
  return a.v >= b;
}
template <typename S>
__device__ __forceinline__ bool operator!=(Dual<S> a, Dual<S> b) {
  return a.v != b.v;
}

// A jet of duals with constants of type S (the rate laws' literals): the
// constant has no tangent of either kind.
template <typename S, int M>
struct Scalar<Jet<Dual<S>, M>> {
  using type = S;
};
template <typename S, int M>
__device__ __forceinline__ Jet<Dual<S>, M> operator+(const Jet<Dual<S>, M>& a, S b) {
  Jet<Dual<S>, M> r = a;
  r.v = a.v + b;
  return r;
}
template <typename S, int M>
__device__ __forceinline__ Jet<Dual<S>, M> operator+(S a, const Jet<Dual<S>, M>& b) {
  Jet<Dual<S>, M> r = b;
  r.v = a + b.v;
  return r;
}
template <typename S, int M>
__device__ __forceinline__ Jet<Dual<S>, M> operator-(const Jet<Dual<S>, M>& a, S b) {
  Jet<Dual<S>, M> r = a;
  r.v = a.v - b;
  return r;
}
template <typename S, int M>
__device__ __forceinline__ Jet<Dual<S>, M> operator-(S a, const Jet<Dual<S>, M>& b) {
  Jet<Dual<S>, M> r;
  r.v = a - b.v;
#pragma unroll
  for (int k = 0; k < M; ++k) r.d[k] = -b.d[k];
  return r;
}
template <typename S, int M>
__device__ __forceinline__ Jet<Dual<S>, M> operator*(const Jet<Dual<S>, M>& a, S b) {
  Jet<Dual<S>, M> r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < M; ++k) r.d[k] = a.d[k] * b;
  return r;
}
template <typename S, int M>
__device__ __forceinline__ Jet<Dual<S>, M> operator*(S a, const Jet<Dual<S>, M>& b) {
  Jet<Dual<S>, M> r;
  r.v = a * b.v;
#pragma unroll
  for (int k = 0; k < M; ++k) r.d[k] = a * b.d[k];
  return r;
}
// Parameters as duals, with tangent 1 on the one that row `dir` holds.
template <typename S>
__device__ __forceinline__ LotkaVolterra::Params<Dual<S>> seed(const LotkaVolterra::Params<S>& p,
                                                               const int* poff, int dir) {
  return {{p.alpha, S(poff[0] == dir)},
          {p.beta, S(poff[1] == dir)},
          {p.gamma, S(poff[2] == dir)},
          {p.delta, S(poff[3] == dir)}};
}
template <typename S>
__device__ __forceinline__ Lorenz::Params<Dual<S>> seed(const Lorenz::Params<S>& p, const int* poff, int dir) {
  return {{p.sigma, S(poff[0] == dir)}, {p.rho, S(poff[1] == dir)}, {p.beta, S(poff[2] == dir)}};
}
template <typename S>
__device__ __forceinline__ VanDerPol::Params<Dual<S>> seed(const VanDerPol::Params<S>& p, const int* poff,
                                                           int dir) {
  return {{p.damping, S(poff[0] == dir)}};
}
template <typename S>
__device__ __forceinline__ Pendulum::Params<Dual<S>> seed(const Pendulum::Params<S>& p, const int* poff, int dir) {
  return {{p.length, S(poff[0] == dir)}};
}
template <typename S>
__device__ __forceinline__ Logistic::Params<Dual<S>> seed(const Logistic::Params<S>& p, const int* poff, int dir) {
  return {{p.growth_rate, S(poff[0] == dir)}, {p.carrying_capacity, S(poff[1] == dir)}};
}
template <typename S>
__device__ __forceinline__ Exponential::Params<Dual<S>> seed(const Exponential::Params<S>& p, const int* poff,
                                                             int dir) {
  return {{p.growth_factor, S(poff[0] == dir)}};
}
template <typename S>
__device__ __forceinline__ HHParams<Dual<S>> seed(const HHParams<S>& p, const int* poff, int dir) {
  return {{p.C, S(poff[0] == dir)},       {p.A, S(poff[1] == dir)},      {p.g_Na, S(poff[2] == dir)},
          {p.E_Na, S(poff[3] == dir)},    {p.g_K, S(poff[4] == dir)},    {p.E_K, S(poff[5] == dir)},
          {p.g_leak, S(poff[6] == dir)},  {p.E_leak, S(poff[7] == dir)}, {p.V_T, S(poff[8] == dir)},
          {p.g_M, S(poff[9] == dir)},     {p.tau_max, S(poff[10] == dir)}, {p.g_L, S(poff[11] == dir)},
          {p.E_Ca, S(poff[12] == dir)},   {p.g_T, S(poff[13] == dir)},   {p.V_x, S(poff[14] == dir)}};
}

}  // namespace
