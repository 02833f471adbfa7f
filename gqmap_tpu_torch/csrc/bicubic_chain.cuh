// The bicubic node term's chain-rule sample of one point, as kernel K13 forms
// it: v1 (csrc/autodiff_gq.cu) at every point, v2 (csrc/node_gq.cu) at the
// points its shared form does not take. One source, so the two variants'
// sums agree bit for bit wherever v2 falls back.
//
// For the 1-based query (Xq, Yq) of frame 2's padded table VV ((Mo + 2) x
// (No + 2)): the query clamped to [1, No] x [1, Mo] by a compare-and-select
// that keeps NaN, its slope as JAX's jnp.clip has it (1 inside, 1/2 on a
// bound, 0 outside and at NaN), the cell ix = min(floor(Xq), No - 1) (a NaN
// query takes the last cell: its weights carry the NaN), the Keys weights
// and their slopes at the fractions, and the 4 x 4 taps of VV summed row by
// row into three separable dots: the sample V, dV/dXq and dV/dYq. With
// diff = i1 - V / 4 and F = sqrt(eps + diff^2) the point gives F, the
// quotient Q = diff / F and the slopes' factors X = dV/dXq (slope_x / 4),
// Y = dV/dYq (slope_y / 4).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace gqmap {
namespace chain {

__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

// jnp.clip(x, lo, hi) = min(max(x, lo), hi) with NaN kept (every comparison
// false), and its derivative by lax.max's and lax.min's tie rule
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi, T* slope) {
  const T a = x > lo ? T(1) : (x == lo ? T(0.5) : T(0));
  const T y = x < lo ? lo : x;
  const T b = y < hi ? T(1) : (y == hi ? T(0.5) : T(0));
  *slope = a * b;
  return y > hi ? hi : y;
}

// The four cubic-convolution weights of ops/interp._cubic_weights at f, and
// their derivatives (ops/interp._cubic_slopes)
template <typename T>
__device__ __forceinline__ void cubic(T f, T w[4], T d[4]) {
  w[0] = ((T(2) - f) * f - T(1)) * f;
  w[1] = (T(3) * f - T(5)) * f * f + T(2);
  w[2] = ((T(4) - T(3) * f) * f + T(1)) * f;
  w[3] = (f - T(1)) * f * f;
  d[0] = (T(4) - T(3) * f) * f - T(1);
  d[1] = (T(9) * f - T(10)) * f;
  d[2] = (T(8) - T(9) * f) * f + T(1);
  d[3] = (T(3) * f - T(2)) * f;
}

// cubic() times 0.25: every coefficient scaled by a power of two, so each
// operation's result (an FMA's too) is cubic()'s times 0.25 exactly
template <typename T>
__device__ __forceinline__ void cubic_quarter(T f, T w[4], T d[4]) {
  w[0] = ((T(0.5) - T(0.25) * f) * f - T(0.25)) * f;
  w[1] = (T(0.75) * f - T(1.25)) * f * f + T(0.5);
  w[2] = ((T(1) - T(0.75) * f) * f + T(0.25)) * f;
  w[3] = (T(0.25) * f - T(0.25)) * f * f;
  d[0] = (T(1) - T(0.75) * f) * f - T(0.25);
  d[1] = (T(2.25) * f - T(2.5)) * f;
  d[2] = (T(2) - T(2.25) * f) * f + T(0.25);
  d[3] = (T(0.75) * f - T(0.5)) * f;
}

// One point's F, Q, X and Y (the header's notes), VV read through L1
template <typename T>
struct Point {
  T F, Q, X, Y;
};

template <typename T>
__device__ __forceinline__ Point<T> point(const T* __restrict__ VV, int Mo, int No, T i1,
                                          T Xq, T Yq, T eps) {
  const int N2 = No + 2;
  const T Nf = static_cast<T>(No);
  const T Mf = static_cast<T>(Mo);
  T slx, sly;
  const T Xc = clip(Xq, T(1), Nf, &slx);
  const T Yc = clip(Yq, T(1), Mf, &sly);
  const T fx = floor_(Xc);
  const T fy = floor_(Yc);
  const int ix = fx <= Nf - T(1) ? static_cast<int>(fx) : No - 1;  // NaN: the last cell
  const int iy = fy <= Mf - T(1) ? static_cast<int>(fy) : Mo - 1;
  T wx[4], dx[4], wy[4], dy[4];
  cubic(Xc - static_cast<T>(ix), wx, dx);
  cubic(Yc - static_cast<T>(iy), wy, dy);
  const T* tap = VV + static_cast<size_t>(iy - 1) * N2 + (ix - 1);
  T V = T(0), Vx = T(0), Vy = T(0);
#pragma unroll
  for (int dr = 0; dr < 4; ++dr) {
    const T* tr = tap + static_cast<size_t>(dr) * N2;
    const T t0 = __ldg(tr), t1 = __ldg(tr + 1), t2 = __ldg(tr + 2), t3 = __ldg(tr + 3);
    const T rx = wx[0] * t0 + wx[1] * t1 + wx[2] * t2 + wx[3] * t3;
    const T rd = dx[0] * t0 + dx[1] * t1 + dx[2] * t2 + dx[3] * t3;
    V += wy[dr] * rx;
    Vx += wy[dr] * rd;
    Vy += dy[dr] * rx;
  }
  Point<T> q;
  const T diff = i1 - V * T(0.25);
  q.F = sqrt_(eps + diff * diff);
  q.Q = diff / q.F;
  q.X = Vx * (T(0.25) * slx);
  q.Y = Vy * (T(0.25) * sly);
  return q;
}

// The seven sums of a lane (Ei unscaled, A1, A2, Ci, Cj, Di, Dj) gain one
// point of weight ww at (XI, XJ): h = ww diff / F
template <typename T>
__device__ __forceinline__ void accumulate(T (&acc)[7], const Point<T>& q, T ww, T XI, T XJ) {
  const T h = ww * q.Q;
  const T gx = h * q.X;
  const T gy = h * q.Y;
  acc[0] += ww * q.F;
  acc[1] += gx;
  acc[2] += gy;
  acc[3] += gx * XI;
  acc[4] += gx * XJ;
  acc[5] += gy * XI;
  acc[6] += gy * XJ;
}

}  // namespace chain
}  // namespace gqmap
