// A forward-mode dual number for the chain math of ekf_chain.cuh: the value
// and one tangent, with the operations that math uses. Comparisons act on
// the value; |v| has the tangent sign(v) dv with sign(0) = 0, as in PyTorch
// and JAX. Instantiating the chain on Dual<S> gives the NLL and its exact
// derivative along the seeded direction (nll_bwd.cu).

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
template <typename S>
__device__ __forceinline__ Dual<S> operator/(Dual<S> a, Dual<S> b) {
  const S q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
template <typename S>
__device__ __forceinline__ Dual<S> operator/(S a, Dual<S> b) {
  const S q = a / b.v;
  return {q, -(q * b.d) / b.v};
}
template <typename S>
__device__ __forceinline__ Dual<S> sqrt(Dual<S> a) {
  const S r = ::sqrt(a.v);
  return {r, a.d / (S(2) * r)};
}
template <typename S>
__device__ __forceinline__ Dual<S> log(Dual<S> a) {
  return {::log(a.v), a.d / a.v};
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

// Parameters as duals, with tangent 1 on the one that row `dir` holds.
template <typename S>
__device__ __forceinline__ LotkaVolterra::Params<Dual<S>> seed(const LotkaVolterra::Params<S>& p,
                                                               const int* poff, int dir) {
  return {{p.alpha, S(poff[0] == dir)},
          {p.beta, S(poff[1] == dir)},
          {p.gamma, S(poff[2] == dir)},
          {p.delta, S(poff[3] == dir)}};
}

}  // namespace
