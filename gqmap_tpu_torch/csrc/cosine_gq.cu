// Kernel K1: the six closed-form cosine mode sums of the node (data) term.
//
// Replaces gqmap_tpu/kernels/cosine_gq.py::cos_mode_sums_pallas (its "v1"
// body: the full A x B mode sum). Math as in gqmap_tpu_torch/ops/cosine.py
// (_mode_sums, the plain version held against this kernel):
//
//   W-/+ = exp(-(a s1 - b s2)^2 / 2 - a b s1 s2 (1 -/+ p))   (stable split)
//   E0 = sum c (W-C- + W+C+)     A1 = sum c a (W-S- + W+S+)
//   A2 = sum c b (W-S- - W+S+)   Aa = sum c a^2 (W-C- + W+C+)
//   Ab = sum c b^2 (W-C- + W+C+) Ax = sum c a b (W-C- - W+C+)
//
// with C-/+ = cos(a ph1 -/+ b ph2), S-/+ = sin(...) carried by the rotation
// recurrences of (cos, sin)(a ph1) over a and (cos, sin)(b ph2) over b, so
// the loop body has two exp and no sin/cos.
//
// What bounds it on an H100: at the flagship shape (A=64, B=16, L=3,
// 376x452 sites) one call reads the 0.70 GB f32 coefficient field (about
// 0.21 ms at 3.35 TB/s) and evaluates 5.2e8 (a, b, l, site) modes of ~40
// flops and 2 exp each (about 2e10 flops, 1e9 exp: the FP32 pipes and the
// SFU exp rate dominate). The design answers both: one thread per lattice
// site loops over all L components, so every coefficient c[a, b, site] is
// read from device memory exactly once per call (coalesced along the site
// axis), and all carried state (per-l phases, recurrences and the six sums)
// lives in registers; L is a template parameter so those per-l arrays stay
// in registers. The adaptive cutoff and the exp-free "recur" body of the
// TPU kernel are later work (ROADMAP).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ void sincos_(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sincos_(double x, double* s, double* c) { sincos(x, s, c); }

constexpr int kThreads = 128;

// sp:     (5, L, S)  ph1, ph2, s1, s2, p per component and site
// coeffs: (A, B, S)  cosine coefficients
// out:    (6, L, S)  E0, A1, A2, Aa, Ab, Ax
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
cos_mode_sums_kernel(const T* __restrict__ sp, const T* __restrict__ coeffs,
                     T* __restrict__ out, int S, int A, int B) {
  const int site = blockIdx.x * blockDim.x + threadIdx.x;
  if (site >= S) return;
  const size_t LS = static_cast<size_t>(L) * S;

  T s1[L], s2[L], gm[L], gp[L], c1[L], sn1[L], c2[L], sn2[L], ca[L], sa[L];
  T E0[L], A1[L], A2[L], Aa[L], Ab[L], Ax[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const size_t i = static_cast<size_t>(l) * S + site;
    const T ph1 = sp[i];
    const T ph2 = sp[LS + i];
    s1[l] = sp[2 * LS + i];
    s2[l] = sp[3 * LS + i];
    const T p = sp[4 * LS + i];
    gm[l] = s1[l] * s2[l] * (T(1) - p);
    gp[l] = s1[l] * s2[l] * (T(1) + p);
    sincos_(ph1, &sn1[l], &c1[l]);
    sincos_(ph2, &sn2[l], &c2[l]);
    ca[l] = T(1);
    sa[l] = T(0);
    E0[l] = A1[l] = A2[l] = Aa[l] = Ab[l] = Ax[l] = T(0);
  }

  const T* c = coeffs + site;
  for (int a = 0; a < A; ++a) {
    const T af = static_cast<T>(a);
    T as1[L], agm[L], agp[L], cb[L], sb[L];
    T sE[L], sEb[L], sP[L], sPm[L], sXb[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      as1[l] = af * s1[l];
      agm[l] = af * gm[l];
      agp[l] = af * gp[l];
      cb[l] = T(1);
      sb[l] = T(0);
      sE[l] = sEb[l] = sP[l] = sPm[l] = sXb[l] = T(0);
    }
    const T* ca_row = c + static_cast<size_t>(a) * B * S;
    for (int b = 0; b < B; ++b) {
      const T cab = ca_row[static_cast<size_t>(b) * S];
      const T bf = static_cast<T>(b);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const T m = as1[l] - bf * s2[l];
        const T h = T(-0.5) * (m * m);
        const T Wm = exp_(h - bf * agm[l]);
        const T Wp = exp_(h - bf * agp[l]);
        const T t1 = ca[l] * cb[l];
        const T t2 = sa[l] * sb[l];
        const T t3 = sa[l] * cb[l];
        const T t4 = ca[l] * sb[l];
        const T cWm = cab * Wm;
        const T cWp = cab * Wp;
        const T cU = cWm * (t1 + t2);  // c W- C-
        const T cV = cWp * (t1 - t2);  // c W+ C+
        const T cP = cWm * (t3 - t4);  // c W- S-
        const T cQ = cWp * (t3 + t4);  // c W+ S+
        const T uv = cU + cV;
        sE[l] += uv;
        sEb[l] += (bf * bf) * uv;
        sP[l] += cP + cQ;
        sPm[l] += bf * (cP - cQ);
        sXb[l] += bf * (cU - cV);
        const T cbn = cb[l] * c2[l] - sb[l] * sn2[l];
        sb[l] = sb[l] * c2[l] + cb[l] * sn2[l];
        cb[l] = cbn;
      }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      E0[l] += sE[l];
      A1[l] += af * sP[l];
      A2[l] += sPm[l];
      Aa[l] += (af * af) * sE[l];
      Ab[l] += sEb[l];
      Ax[l] += af * sXb[l];
      const T can = ca[l] * c1[l] - sa[l] * sn1[l];
      sa[l] = sa[l] * c1[l] + ca[l] * sn1[l];
      ca[l] = can;
    }
  }

#pragma unroll
  for (int l = 0; l < L; ++l) {
    const size_t i = static_cast<size_t>(l) * S + site;
    out[i] = E0[l];
    out[LS + i] = A1[l];
    out[2 * LS + i] = A2[l];
    out[3 * LS + i] = Aa[l];
    out[4 * LS + i] = Ab[l];
    out[5 * LS + i] = Ax[l];
  }
}

template <typename T>
int launch_cos_mode_sums(const void* sp, const void* coeffs, void* out, int L, int S,
                         int A, int B, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((S + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* spt = static_cast<const T*>(sp);
  const T* ct = static_cast<const T*>(coeffs);
  T* ot = static_cast<T*>(out);
  switch (L) {
    case 1: cos_mode_sums_kernel<T, 1><<<grid, kThreads, 0, st>>>(spt, ct, ot, S, A, B); break;
    case 2: cos_mode_sums_kernel<T, 2><<<grid, kThreads, 0, st>>>(spt, ct, ot, S, A, B); break;
    case 3: cos_mode_sums_kernel<T, 3><<<grid, kThreads, 0, st>>>(spt, ct, ot, S, A, B); break;
    case 4: cos_mode_sums_kernel<T, 4><<<grid, kThreads, 0, st>>>(spt, ct, ot, S, A, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch; the Python wrapper raises on a non-zero code.
extern "C" int gqmap_cos_mode_sums_f32(const void* sp, const void* coeffs, void* out,
                                       int L, int S, int A, int B, int device,
                                       void* stream) {
  return launch_cos_mode_sums<float>(sp, coeffs, out, L, S, A, B, device, stream);
}

extern "C" int gqmap_cos_mode_sums_f64(const void* sp, const void* coeffs, void* out,
                                       int L, int S, int A, int B, int device,
                                       void* stream) {
  return launch_cos_mode_sums<double>(sp, coeffs, out, L, S, A, B, device, stream);
}

extern "C" const char* gqmap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
