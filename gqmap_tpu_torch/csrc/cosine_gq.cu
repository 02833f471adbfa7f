// Kernel K1: the six closed-form cosine mode sums of the node (data) term.
//
// Replaces gqmap_tpu/kernels/cosine_gq.py::cos_mode_sums_pallas with all
// three of its variants: "v1" (the full A x B mode sum, exp body), "adaptive"
// (the exp body with the u-degree cutoff) and "recur" (the cutoff plus the
// exp-free recurrence body where a bound proves it safe; the default, as in
// the JAX package). Math as in gqmap_tpu_torch/ops/cosine.py (_mode_sums,
// the plain version held against this kernel, always the full sum):
//
//   W-/+ = exp(-(a s1 - b s2)^2 / 2 - a b s1 s2 (1 -/+ p))   (stable split)
//   E0 = sum c (W-C- + W+C+)     A1 = sum c a (W-S- + W+S+)
//   A2 = sum c b (W-S- - W+S+)   Aa = sum c a^2 (W-C- + W+C+)
//   Ab = sum c b^2 (W-C- + W+C+) Ax = sum c a b (W-C- - W+C+)
//
// with C-/+ = cos(a ph1 -/+ b ph2), S-/+ = sin(...). Writing apl = c (W- + W+)
// and ami = c (W- - W+), every sum is (ca, sa) = (cos, sin)(a ph1) times one
// of six sums over b alone: Sc0 = sum cb apl, Ss0 = sum sb ami, Sc2 = sum b^2
// cb apl, Ss2 = sum b^2 sb ami, Sc1 = sum b cb ami, Ss1 = sum b sb apl, with
// (cb, sb) = (cos, sin)(b ph2); e.g. E0 += ca Sc0 + sa Ss0. So a mode costs
// ten operations on top of its weights, and (ca, sa) and (cb, sb) advance by
// rotation recurrences (no sin/cos in the loops).
//
// Cutoff and recurrence (gqmap_tpu/kernels/cosine_gq.py:_adaptive_trip and
// :214-288): every weight is below exp(-(a s1 - (B-1) s2)^2 / 2), so once
// a s1_min > (B-1) s2_max + 10 the rest of the u-degrees add less than e^-50
// and are skipped. The recur body replaces the two exp of each mode by
//   W-(b+1) = W-(b) f-(b), f-(b+1) = f-(b) r, f-(0) = exp(a s1 s2 p - s2^2/2),
//   r = exp(-s2^2) (W+ with the sign of p flipped), W-(0) = W+(0) = exp(-(a s1)^2/2),
// three exp per (a, component, site) and four multiplies per mode, taken only
// when (a_hi s1_max + B s2_max) < 8.9, where no weight can underflow and later
// recover; elsewhere the exp body runs. Both change the result only at
// rounding level (the plain full sum is the yardstick).
//
// Layout. A block is one warp and serves a tile of 32 consecutive flat
// sites, one a lane, over all A u-degrees, with every component of its site
// in registers (L a template parameter, 1 to 4). More components run as
// groups of at most 4 consecutive ones, a launch a group, each reading and
// writing its slice of the whole stacks in place (kernels/cosine_gq.py
// component_groups); the coefficient field then streams once a group. The
// cutoff statistics (s1_min, s1_max, s2_max over every component of the
// group at the tile's valid lanes;
// out-of-range lanes count as +inf for the min, 0 for the max) come from warp
// shuffles, so trip count and body are uniform across the warp. Out-of-range
// lanes read a real site and store nothing; every other lane writes its six
// sums straight from registers, once. No atomics: the result is the same
// bits on every run. B = 16 (the flagship degree) is a template instance with
// the b loop unrolled, so b and b^2 are constants, and the next u-degree's 16
// coefficients are loaded into registers while this one computes.
//
// What bounds it on an H100 (flagship: A=64, B=16, L=3, S=169,952 sites,
// f32): the 0.70 GB coefficient field streams once, coalesced along the site
// axis (0.21 ms at 3.35 TB/s), and a converged call evaluates A.B.L.S = 5.2e8
// modes of 28 flops (0.22 ms at 67 TFLOP/s). cuobjdump: the recur u-degree
// loop is about 20.6 SASS instructions a mode (weights 4, the six b sums 10,
// recurrences 4, rotation 4), the exp loop about 35 (two accurate exp); at
// 132 SMs x 128 lanes x 1.98 GHz that is 0.32 ms for recur and 0.55 ms for the
// exp body (chip_smoke.py prints both counts and the ptxas report; measured
// times in PERF.md section 6).
// Waves: the f32, L = 3, B = 16 instance takes 255 registers (no spills), so
// an SM holds 8 warps; the 5,311 one-warp blocks run in ~5 waves of 1,056 with
// a last wave of 31 blocks (0.6% of the work). Splitting the u-degrees of a
// tile over W warps of a block (W = 2, 4, 8; partial sums added in shared
// memory) measured no faster for recur converged and 1.3-1.9x slower from
// init, where the cutoff keeps ~18 of 64 u-degrees and a contiguous split
// idles all but the first warp (PERF.md section 6), so a block is one warp.
// The f64 B = 16 instances also reach 255 registers and spill (L = 3: 1.5 KB
// a thread); f64 is not the flagship's dtype.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 32;  // sites per block (one warp), one per lane

enum Variant : int { kV1 = 0, kAdaptive = 1, kRecur = 2 };

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float ceil_(float x) { return ceilf(x); }
__device__ __forceinline__ double ceil_(double x) { return ceil(x); }
__device__ __forceinline__ float fmin_(float x, float y) { return fminf(x, y); }
__device__ __forceinline__ double fmin_(double x, double y) { return fmin(x, y); }
__device__ __forceinline__ float fmax_(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double fmax_(double x, double y) { return fmax(x, y); }
__device__ __forceinline__ void sincos_(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sincos_(double x, double* s, double* c) { sincos(x, s, c); }
template <typename T>
__device__ __forceinline__ T inf_() { return static_cast<T>(__int_as_float(0x7f800000)); }

template <typename T>
__device__ __forceinline__ T warp_min(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmin_(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__device__ __forceinline__ T warp_max(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmax_(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// u-degrees [0, trip) of A whose modes reach e^-50 of the largest:
// _adaptive_trip of the JAX kernel, clip(ceil(a_cut) + 1, 0, A).
template <typename T>
__device__ __forceinline__ int adaptive_trip(T s1_min, T s2_max, int A, int B) {
  const T a_cut = ceil_((T(B - 1) * s2_max + T(10)) / fmax_(s1_min, T(1e-20)));
  if (!(a_cut < T(A))) return A;  // no cutoff (or NaN)
  return max(static_cast<int>(a_cut) + 1, 0);
}

// The six sums over b of one (a, component): see the header.
template <typename T>
struct BSums {
  T c0, s0, c2, s2, c1, s1;
};

// Mode b = 0: cb = 1, sb = 0, and every b-weighted term vanishes.
template <typename T>
__device__ __forceinline__ void first_mode(BSums<T>& x, T apl) {
  x.c0 = apl;
  x.s0 = x.c2 = x.s2 = x.c1 = x.s1 = T(0);
}

template <typename T>
__device__ __forceinline__ void add_mode(BSums<T>& x, T bf, T cb, T sb, T apl, T ami) {
  const T u = cb * apl;
  const T v = sb * ami;
  x.c0 += u;
  x.s0 += v;
  x.c2 += (bf * bf) * u;
  x.s2 += (bf * bf) * v;
  x.c1 += bf * (cb * ami);
  x.s1 += bf * (sb * apl);
}

// The coefficients c[a, b, site] of the chunk's u-degrees in order. With
// prefetching (BS > 0), the next u-degree's B values are loaded into
// registers while this one computes.
template <typename T, int BS>
struct CoeffStream {
  static constexpr bool kPf = BS > 0;
  const T* __restrict__ row;
  size_t S;
  int nb;
  T cur[kPf ? BS : 1], nxt[kPf ? BS : 1];

  __device__ __forceinline__ CoeffStream(const T* r, size_t S_, int nb_, int trip)
      : row(r), S(S_), nb(nb_) {
    if constexpr (kPf) {
#pragma unroll
      for (int b = 0; b < BS; ++b) cur[b] = trip > 0 ? row[b * S] : T(0);
    }
  }
  __device__ __forceinline__ T operator()(int b) const {
    if constexpr (kPf) {
      return cur[b];
    } else {
      return row[b * S];
    }
  }
  __device__ __forceinline__ void prefetch(bool more) {
    if constexpr (kPf) {
      const T* next = row + static_cast<size_t>(nb) * S;
#pragma unroll
      for (int b = 0; b < BS; ++b) nxt[b] = more ? next[b * S] : T(0);
    }
  }
  __device__ __forceinline__ void advance() {
    row += static_cast<size_t>(nb) * S;
    if constexpr (kPf) {
#pragma unroll
      for (int b = 0; b < BS; ++b) cur[b] = nxt[b];
    }
  }
};

// Per-site, per-component state that every u-degree reads.
template <typename T, int L>
struct SiteState {
  T c1[L], sn1[L], c2[L], sn2[L], s1[L], s2[L], p[L];
  T ca[L], sa[L];                          // (cos, sin)(a ph1), advanced over a
  T E0[L], A1[L], A2[L], Aa[L], Ab[L], Ax[L];
};

// Folds one u-degree's b sums into the six mode sums and advances (ca, sa).
template <typename T, int L>
__device__ __forceinline__ void finish_a(SiteState<T, L>& st, const BSums<T> (&x)[L], T af) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const T ca = st.ca[l], sa = st.sa[l];
    const T sE = ca * x[l].c0 + sa * x[l].s0;
    st.E0[l] += sE;
    st.A1[l] += af * (sa * x[l].c0 - ca * x[l].s0);
    st.A2[l] += sa * x[l].c1 - ca * x[l].s1;
    st.Aa[l] += (af * af) * sE;
    st.Ab[l] += ca * x[l].c2 + sa * x[l].s2;
    st.Ax[l] += af * (ca * x[l].c1 + sa * x[l].s1);
    st.ca[l] = ca * st.c1[l] - sa * st.sn1[l];
    st.sa[l] = sa * st.c1[l] + ca * st.sn1[l];
  }
}

// The exp body: two exp a mode. crow points at c[0, 0, site]; BS > 0 is the
// compile-time v-degree count (loop unrolled), BS = 0 takes B at run time.
template <typename T, int L, int BS>
__device__ __forceinline__ void exp_body(SiteState<T, L>& st, const T* crow,
                                         int trip, int B, size_t S) {
  const int nb = BS > 0 ? BS : B;
  T gm[L], gp[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    gm[l] = st.s1[l] * st.s2[l] * (T(1) - st.p[l]);
    gp[l] = st.s1[l] * st.s2[l] * (T(1) + st.p[l]);
  }
  CoeffStream<T, BS> c(crow, S, nb, trip);
  for (int j = 0; j < trip; ++j, c.advance()) {
    c.prefetch(j + 1 < trip);
    const T af = static_cast<T>(j);
    T as1[L], agm[L], agp[L], cb[L], sb[L];
    BSums<T> x[L];
    const T c0 = c(0);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      as1[l] = af * st.s1[l];
      agm[l] = af * gm[l];
      agp[l] = af * gp[l];
      const T w = exp_(T(-0.5) * (as1[l] * as1[l]));
      first_mode(x[l], T(2) * (c0 * w));
      cb[l] = st.c2[l];
      sb[l] = st.sn2[l];
    }
#pragma unroll
    for (int b = 1; b < nb; ++b) {
      const T cab = c(b);
      const T bf = static_cast<T>(b);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const T m = as1[l] - bf * st.s2[l];
        const T h = T(-0.5) * (m * m);
        const T cm = cab * exp_(h - bf * agm[l]);
        const T cp = cab * exp_(h - bf * agp[l]);
        add_mode(x[l], bf, cb[l], sb[l], cm + cp, cm - cp);
        const T cbn = cb[l] * st.c2[l] - sb[l] * st.sn2[l];
        sb[l] = sb[l] * st.c2[l] + cb[l] * st.sn2[l];
        cb[l] = cbn;
      }
    }
    finish_a(st, x, af);
  }
}

// The recur body: three exp per (a, component) and none a mode.
template <typename T, int L, int BS>
__device__ __forceinline__ void recur_body(SiteState<T, L>& st, const T* crow,
                                           int trip, int B, size_t S) {
  const int nb = BS > 0 ? BS : B;
  T spp[L], hs2[L], rr[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    spp[l] = st.s1[l] * st.s2[l] * st.p[l];
    hs2[l] = T(0.5) * (st.s2[l] * st.s2[l]);
    rr[l] = exp_(-(st.s2[l] * st.s2[l]));
  }
  CoeffStream<T, BS> c(crow, S, nb, trip);
  for (int j = 0; j < trip; ++j, c.advance()) {
    c.prefetch(j + 1 < trip);
    const T af = static_cast<T>(j);
    T wm[L], wp[L], fm[L], fp[L], cb[L], sb[L];
    BSums<T> x[L];
    const T c0 = c(0);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const T as1 = af * st.s1[l];
      const T w = exp_(T(-0.5) * (as1 * as1));
      const T arg = af * spp[l];
      fm[l] = exp_(arg - hs2[l]);
      fp[l] = exp_(-arg - hs2[l]);
      first_mode(x[l], T(2) * (c0 * w));
      wm[l] = w * fm[l];
      wp[l] = w * fp[l];
      fm[l] *= rr[l];
      fp[l] *= rr[l];
      cb[l] = st.c2[l];
      sb[l] = st.sn2[l];
    }
#pragma unroll
    for (int b = 1; b < nb; ++b) {
      const T cab = c(b);
      const T bf = static_cast<T>(b);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const T cm = cab * wm[l];
        const T cp = cab * wp[l];
        add_mode(x[l], bf, cb[l], sb[l], cm + cp, cm - cp);
        wm[l] *= fm[l];
        fm[l] *= rr[l];
        wp[l] *= fp[l];
        fp[l] *= rr[l];
        const T cbn = cb[l] * st.c2[l] - sb[l] * st.sn2[l];
        sb[l] = sb[l] * st.c2[l] + cb[l] * st.sn2[l];
        cb[l] = cbn;
      }
    }
    finish_a(st, x, af);
  }
}

// sp:       (5, Lt, S)  ph1, ph2, s1, s2, p per component and site, from the
//           group's first component (Lt: the components of the whole stack)
// coeffs:   (A, B, S)   cosine coefficients
// out:      (6, Lt, S)  E0, A1, A2, Aa, Ab, Ax, from the group's first component
// counters: null, or 3 int64: warps (32-site tiles) on the recur body, warps
//           on the exp body, modes evaluated (valid sites only)
// A launch computes the L consecutive components of one group: a row of sp
// and out is Lt S values apart, so a group reads and writes its slice of the
// whole stack in place.
template <typename T, int L, int BS>
__global__ void __launch_bounds__(kTile)
cos_mode_sums_kernel(const T* __restrict__ sp, const T* __restrict__ coeffs,
                     T* __restrict__ out, unsigned long long* __restrict__ counters,
                     int Lt, int S, int A, int B, int variant) {
  const int lane = threadIdx.x;
  const int tile = blockIdx.x * kTile;
  const bool valid = tile + lane < S;
  const int site = valid ? tile + lane : S - 1;
  const size_t LS = static_cast<size_t>(Lt) * S;  // a row of the stacks

  SiteState<T, L> st;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const size_t i = static_cast<size_t>(l) * S + site;
    st.s1[l] = sp[2 * LS + i];
    st.s2[l] = sp[3 * LS + i];
    st.p[l] = sp[4 * LS + i];
    sincos_(sp[i], &st.sn1[l], &st.c1[l]);
    sincos_(sp[LS + i], &st.sn2[l], &st.c2[l]);
    st.ca[l] = T(1);
    st.sa[l] = T(0);
    st.E0[l] = st.A1[l] = st.A2[l] = st.Aa[l] = st.Ab[l] = st.Ax[l] = T(0);
  }

  int trip = A;
  bool recur = false;
  if (variant != kV1) {
    T s1_min = inf_<T>(), s1_max = T(0), s2_max = T(0);
    if (valid) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        s1_min = fmin_(s1_min, st.s1[l]);
        s1_max = fmax_(s1_max, st.s1[l]);
        s2_max = fmax_(s2_max, st.s2[l]);
      }
    }
    s1_min = warp_min(s1_min);
    s1_max = warp_max(s1_max);
    s2_max = warp_max(s2_max);
    trip = adaptive_trip(s1_min, s2_max, A, B);
    recur = variant == kRecur &&
            static_cast<T>(trip) * s1_max + static_cast<T>(B) * s2_max < T(8.9);
  }
  if (counters != nullptr && lane == 0) {
    atomicAdd(counters + (recur ? 0 : 1), 1ull);
    atomicAdd(counters + 2, static_cast<unsigned long long>(trip) * B * L * min(kTile, S - tile));
  }

  const T* crow = coeffs + site;
  if (recur) {
    recur_body<T, L, BS>(st, crow, trip, B, S);
  } else {
    exp_body<T, L, BS>(st, crow, trip, B, S);
  }

  if (!valid) return;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const size_t i = static_cast<size_t>(l) * S + site;
    out[i] = st.E0[l];
    out[LS + i] = st.A1[l];
    out[2 * LS + i] = st.A2[l];
    out[3 * LS + i] = st.Aa[l];
    out[4 * LS + i] = st.Ab[l];
    out[5 * LS + i] = st.Ax[l];
  }
}

template <typename T, int L>
void launch_l(const T* sp, const T* coeffs, T* out, unsigned long long* counters, int Lt,
              int S, int A, int B, int variant, cudaStream_t st) {
  const dim3 grid((S + kTile - 1) / kTile);
  if (B == 16) {
    cos_mode_sums_kernel<T, L, 16><<<grid, kTile, 0, st>>>(sp, coeffs, out, counters, Lt, S,
                                                           A, B, variant);
  } else {
    cos_mode_sums_kernel<T, L, 0><<<grid, kTile, 0, st>>>(sp, coeffs, out, counters, Lt, S, A,
                                                          B, variant);
  }
}

template <typename T>
int launch_cos_mode_sums(const void* sp, const void* coeffs, void* out, void* counters,
                         int L, int Lt, int S, int A, int B, int variant, int device,
                         void* stream) {
  if (variant < kV1 || variant > kRecur || A < 1 || B < 1 || Lt < L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* spt = static_cast<const T*>(sp);
  const T* ct = static_cast<const T*>(coeffs);
  T* ot = static_cast<T*>(out);
  auto* cnt = static_cast<unsigned long long*>(counters);
  switch (L) {
    case 1: launch_l<T, 1>(spt, ct, ot, cnt, Lt, S, A, B, variant, st); break;
    case 2: launch_l<T, 2>(spt, ct, ot, cnt, Lt, S, A, B, variant, st); break;
    case 3: launch_l<T, 3>(spt, ct, ot, cnt, Lt, S, A, B, variant, st); break;
    case 4: launch_l<T, 4>(spt, ct, ot, cnt, Lt, S, A, B, variant, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch; the Python wrapper raises on a non-zero code. A launch
// runs one group of L (1 to 4) components of an Lt-component stack: sp and
// out point at the group's first component. variant: 0 "v1", 1 "adaptive",
// 2 "recur"; counters: null or 3 int64 on the device.
extern "C" int gqmap_cos_mode_sums_f32(const void* sp, const void* coeffs, void* out,
                                       void* counters, int L, int Lt, int S, int A, int B,
                                       int variant, int device, void* stream) {
  return launch_cos_mode_sums<float>(sp, coeffs, out, counters, L, Lt, S, A, B, variant,
                                     device, stream);
}

extern "C" int gqmap_cos_mode_sums_f64(const void* sp, const void* coeffs, void* out,
                                       void* counters, int L, int Lt, int S, int A, int B,
                                       int variant, int device, void* stream) {
  return launch_cos_mode_sums<double>(sp, coeffs, out, counters, L, Lt, S, A, B, variant,
                                      device, stream);
}

extern "C" const char* gqmap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
