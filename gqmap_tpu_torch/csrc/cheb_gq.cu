// Kernel K5: the Chebyshev data term's tensor-rule (K^2-point) node quadrature, raw sums.
//
// Replaces the Chebyshev node term, which the JAX package runs as one XLA
// scan and no Pallas kernel: gqmap_tpu/ops/gq.py::gq_accumulate over
// gqmap_tpu/ops/chebyshev.py::make_node_pot_chebyshev (a lax.scan that
// carries the u-degree recurrence over blocks of a_block degrees; a_block
// changes no value and is not carried over). The plain version held against
// this kernel is gqmap_tpu_torch/kernels/cheb_gq.py::cheb_gq_torch. For each
// flow site (m, n), each component l with state u1, u2, o1, o2, p and each
// point (XI, XJ) = (x_i, x_j) of the K^2 rule: z_i = s XI + t XJ,
// z_j = t XI + s XJ (s, t = (sqrt(1 + p) +- sqrt(1 - p)) / 2, as
// ops/gq._whitened_steps), x1 = sqrt2 o1 z_i + u1, x2 = sqrt2 o2 z_j + u2;
// the sample in the box, u' = clip((x1 - cu) / ru, -1, 1) and v' likewise,
// by compare and select (a NaN query stays NaN, as through torch.clamp and
// jnp.clip; fminf/fmaxf would drop it); the series
// f = sum_a T_a(u') sum_b C[a, b, m, n] T_b(v'), both bases by the three-term
// recurrence; then the six raw sums Ei, Z1, Z2, Sa, Sm, Sxy of
// ops/gq.gq_accumulate on fv = w_i w_j f. The coefficients already hold
// -lambda_d. finalize() stays in torch, as for K3 and K4.
//
// What bounds it: float32 operations. A sample costs 2PQ for the
// contraction, 2P for the outer sum and 2(P + Q) for the two recurrences
// (kernels/roofline.k5_work): 3,488 at 96 x 16, so full_mixture's 41.3 M
// samples a call (L = 3, K = 9, 376 x 452 sites) are 144 GFLOP, 2.15 ms at
// the data sheet's 67 TFLOP/s, against 1.07 GB of coefficients and state
// (0.32 ms at 3.35 TB/s). A site's coefficient block is shared by its L K^2
// samples, so the design feeds the FMA pipe from registers and reads each
// coefficient from shared memory once for several samples:
// * a CTA takes spc consecutive sites (the field is site major: their blocks
//   are one contiguous run) and stages their blocks in shared memory, with
//   columns padded by zeros to the instance's width QB (8, 16, 32 or 64; a
//   zero column adds nothing); a block over the budget is staged a chunk of
//   u-degree rows at a time, the lanes' recurrences carried across chunks;
// * a site's G lanes (whole warps) split its L K^2 samples, sample j =
//   l K^2 + p (p the point, XJ outer and XI inner as the plain table): lane g
//   takes j = g, g + G, ..., R of them a round, keeps T_b(v') for b < QB of
//   each in registers and walks a with the recurrence; each coefficient row
//   C[a, 0..QB) is read as 16-byte broadcast loads (every lane of a warp at
//   one address) and used for its R samples: R QB FMAs for QB / 4 loads in
//   float;
// * the order of the series' sums, for float32: each row's sum over b >= 1
//   from the highest degree down (the coefficients fall with the degree),
//   column 0 in a sum of its own over a >= 1, C[0, 0] added last. A row's
//   sum depends on v' alone and is rounded once for the K points of a rule
//   row that share v'; with the large column-0 terms in it, that shared
//   error put the v-weighted sums (Z2, Sxy) at sigma = 0.05 above twice the
//   plain version's error (which shares its u-only sums' errors over a rule
//   column instead); apart, the large terms round where u' and v' meet;
// * each sample's f goes to shared memory; then a site's warps take its
//   components in turn, 32 lanes over the K^2 points (lane k: k, k + 32, ...)
//   with the six sums on w_i w_j f, met by a fixed xor tree. No atomics and
//   one order: a site's sums depend only on its state and its coefficients,
//   so a shard's block gives the whole lattice's values bit for bit, whatever
//   CTA holds the site.
// Instances: QB in {8, 16, 32, 64} (Q = 16 and 32 exactly: the presets'
// 64 x 16, 96 x 16 and 96 x 32), R = 4, 4, 2, 1 samples a lane in float and
// 2, 2, 1, 1 in double. P is a runtime loop: its counter and branch are 2 of
// some 80 instructions an a-step at QB = 16. Shared memory stays under 47 KB,
// so no cudaFuncSetAttribute is set, before or during a graph capture.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;           // lanes a CTA, at most
constexpr int kMaxK = 64;
constexpr int kMaxQ = 64;
constexpr int kMaxDynSmem = 47 * 1024;  // beside no static shared memory
constexpr double kSqrt2 = 1.41421356237309504880;

// The 1-D rule in double for both instances (host order: x[0..K), then
// w[0..K)): a point's constants (x_i, x_j, w_i w_j, x_i x_j, x_i^2 + x_j^2,
// x_i^2 - x_j^2) are formed in double and rounded once, as the plain
// version's table (ops/quadrature.build_table) holds them.
struct NodeRule {
  double x[kMaxK], w[kMaxK];
};

// Kernel parameters live in the constant bank: the rule (1,024 B) and the
// other arguments (under 200 B) stay within the classic 4 KB limit.
static_assert(sizeof(NodeRule) + 200 <= 4096, "rule exceeds parameter space");

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

// x clipped to [-1, 1], NaN kept
template <typename T>
__device__ __forceinline__ T clip_keep_nan(T x) {
  return x < T(-1) ? T(-1) : (x > T(1) ? T(1) : x);
}

// 16 bytes of a row: four floats or two doubles
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static float at(const float4& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static double at(const double2& v, int k) { return k == 0 ? v.x : v.y; }
};

// S[r] = sum_{b >= 1} row[b] T_b of sample r, one FMA chain a sample from
// the highest degree down (the coefficients fall with the degree: the small
// terms meet first); returns row[0], T_0 = 1's coefficient, which the caller
// sums apart: S depends on v' alone, so its rounding is shared by the K
// points of a rule row, and left out of it the large column-0 term rounds
// only where u' and v' meet
template <typename T, int QB, int R>
__device__ __forceinline__ T contract(const T* __restrict__ row, const T (&tb)[R][QB],
                                      T (&S)[R]) {
  using V = Vec16<T>;
  T c0 = T(0);
#pragma unroll
  for (int b = QB - V::n; b >= 0; b -= V::n) {
    const typename V::type c = *reinterpret_cast<const typename V::type*>(row + b);
#pragma unroll
    for (int k = V::n - 1; k >= 0; --k) {
      if (b + k == 0) {
        c0 = V::at(c, 0);
        continue;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        S[r] = b + k == QB - 1 ? V::at(c, k) * tb[r][QB - 1]
                               : fma_(V::at(c, k), tb[r][b + k], S[r]);
      }
    }
  }
  return c0;
}

// Rows [a0, a0 + rows) of the blocks of sites site0 .. site0 + nsites - 1
// into shared memory, QB elements a row (the columns past Q are not written)
template <typename T, int QB>
__device__ __forceinline__ void stage(T* __restrict__ csm, const T* __restrict__ coeffs, int site0,
                                      int nsites, int P, int Q, int PA, int a0, int rows, int tid,
                                      int nt) {
  using V = Vec16<T>;
  const size_t PQ = static_cast<size_t>(P) * Q;
  const int run = rows * Q;
  for (int s = 0; s < nsites; ++s) {
    const T* src = coeffs + static_cast<size_t>(site0 + s) * PQ + static_cast<size_t>(a0) * Q;
    T* dst = csm + s * PA * QB;
    if (Q == QB && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      // rows * QB elements, a multiple of the vector: 16-byte copies
      const typename V::type* s16 = reinterpret_cast<const typename V::type*>(src);
      typename V::type* d16 = reinterpret_cast<typename V::type*>(dst);
      for (int e = tid; e < run / V::n; e += nt) d16[e] = __ldg(s16 + e);
    } else {
      for (int e = tid; e < run; e += nt) {
        const int a = e / Q;
        dst[a * QB + (e - a * Q)] = __ldg(src + e);
      }
    }
  }
}

// coeffs:             (S, P, Q) site major: site (m, n) = m N + n, row a, column b
// muu, muv, su, sv, pn: (L, S) state
// out:                (6, L, S)  Ei, Z1, Z2, Sa, Sm, Sxy
// grid:               ceil(S / spc) CTAs of spc x G lanes; lane g = tid % G of
//                     the CTA's site tid / G
// dynamic shared memory: the rule's K nodes and K weights (double), spc x PA
// x QB coefficients, spc x L K^2 sample values
template <typename T, int QB, int R>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
cheb_gq_kernel(const T* __restrict__ coeffs, const T* __restrict__ muu,
               const T* __restrict__ muv, const T* __restrict__ su, const T* __restrict__ sv,
               const T* __restrict__ pn, const __grid_constant__ NodeRule rule, int K,
               T* __restrict__ out, int L, int S, int P, int Q, int G, int spc, int PA, T cu,
               T ru, T cv, T rv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K2 = K * K, NS = L * K2;
  double* rx = reinterpret_cast<double*>(smem);  // 2K doubles: a multiple of 16 bytes
  const double* rw = rx + K;
  T* csm = reinterpret_cast<T*>(rx + 2 * K);
  T* fsm = csm + spc * PA * QB;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int slot = tid / G, g = tid - slot * G;
  const int site0 = blockIdx.x * spc;
  const int site = site0 + slot;
  const int nsites = min(spc, S - site0);
  const bool active = slot < nsites;
  const bool whole = PA >= P;

  for (int i = tid; i < 2 * K; i += nt) rx[i] = i < K ? rule.x[i] : rule.w[i - K];
  if (Q < QB) {  // the padded columns: zero once, never written again
    for (int e = tid; e < spc * PA * QB; e += nt) csm[e] = T(0);
    __syncthreads();
  }
  if (whole) stage<T, QB>(csm, coeffs, site0, nsites, P, Q, PA, 0, P, tid, nt);
  __syncthreads();

  const T* cblock = csm + slot * PA * QB;
  for (int base = 0; base < NS; base += G * R) {
    // each sample's basis T_b(v') (b < QB), T_a(u') and T_{a-1}(u') (T_{-1} =
    // T_1 = u' starts the recurrence at a = 0), 2 u' and its series in three
    // parts, the large one last: f = (sum_a T_a S_a + sum_{a >= 1} T_a C[a, 0])
    // + C[0, 0], S_a the row's sum over b >= 1
    T tb[R][QB], ta[R], tp[R], tu[R], acc[R], acc0[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = base + r * G + g;
      T u = T(0), v = T(0);
      if (active && j < NS) {
        const int l = j / K2, p = j - l * K2;
        const int jx = p / K, ix = p - jx * K;
        const int i = l * S + site;
        const T rho = pn[i];
        const T sp = sqrt_(T(1) + rho), sm = sqrt_(T(1) - rho);
        const T s = (sp + sm) * T(0.5), t = (sp - sm) * T(0.5);
        const T xi = static_cast<T>(rx[ix]), xj = static_cast<T>(rx[jx]);
        const T zi = s * xi + t * xj, zj = t * xi + s * xj;
        const T x1 = su[i] * T(kSqrt2) * zi + muu[i];
        const T x2 = sv[i] * T(kSqrt2) * zj + muv[i];
        u = clip_keep_nan((x1 - cu) / ru);
        v = clip_keep_nan((x2 - cv) / rv);
      }
      const T tv = v + v;
      tb[r][0] = T(1);
      tb[r][1] = v;
#pragma unroll
      for (int b = 2; b < QB; ++b) tb[r][b] = fma_(tv, tb[r][b - 1], -tb[r][b - 2]);
      ta[r] = T(1);
      tp[r] = u;
      tu[r] = u + u;
      acc0[r] = T(0);
    }
    T c00 = T(0);
    for (int a0 = 0; a0 < P; a0 += PA) {
      const int rows = min(PA, P - a0);
      if (!whole) {
        __syncthreads();  // every lane done with the last chunk
        stage<T, QB>(csm, coeffs, site0, nsites, P, Q, PA, a0, rows, tid, nt);
        __syncthreads();
      }
      int a = 0;
      if (a0 == 0) {  // row 0: T_0 = 1
        c00 = contract<T, QB, R>(cblock, tb, acc);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T next = fma_(tu[r], ta[r], -tp[r]);
          tp[r] = ta[r];
          ta[r] = next;
        }
        a = 1;
      }
      const T* crow = cblock + a * QB;
#pragma unroll 2
      for (; a < rows; ++a, crow += QB) {
        T S[R];
        const T c0 = contract<T, QB, R>(crow, tb, S);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r] = fma_(ta[r], S[r], acc[r]);
          acc0[r] = fma_(ta[r], c0, acc0[r]);
          const T next = fma_(tu[r], ta[r], -tp[r]);
          tp[r] = ta[r];
          ta[r] = next;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = base + r * G + g;
      if (active && j < NS) fsm[slot * NS + j] = (acc[r] + acc0[r]) + c00;
    }
  }
  __syncthreads();

  // the six sums: a site's G / 32 warps take its components in turn
  const int warp = tid >> 5, lane = tid & 31;
  const int wps = G >> 5;
  const int ws = warp / wps;
  if (ws >= nsites) return;
  const int wsite = site0 + ws;
  const size_t LS = static_cast<size_t>(L) * S;
  for (int l = warp - ws * wps; l < L; l += wps) {
    const T* f = fsm + ws * NS + l * K2;
    T e = T(0), sxi = T(0), sxj = T(0), sxixj = T(0), sx2a = T(0), sx2m = T(0);
    for (int p = lane; p < K2; p += 32) {
      const int jx = p / K, ix = p - jx * K;
      const double xi = rx[ix], xj = rx[jx];
      const T fv = static_cast<T>(rw[ix] * rw[jx]) * f[p];
      e += fv;
      sxi += static_cast<T>(xi) * fv;
      sxj += static_cast<T>(xj) * fv;
      sxixj += static_cast<T>(xi * xj) * fv;
      sx2a += (static_cast<T>(xi * xi + xj * xj) - T(1)) * fv;
      sx2m += static_cast<T>(xi * xi - xj * xj) * fv;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      e += __shfl_xor_sync(0xffffffffu, e, off);
      sxi += __shfl_xor_sync(0xffffffffu, sxi, off);
      sxj += __shfl_xor_sync(0xffffffffu, sxj, off);
      sxixj += __shfl_xor_sync(0xffffffffu, sxixj, off);
      sx2a += __shfl_xor_sync(0xffffffffu, sx2a, off);
      sx2m += __shfl_xor_sync(0xffffffffu, sx2m, off);
    }
    if (lane == 0) {
      const size_t i = static_cast<size_t>(l) * S + wsite;
      const T rho = pn[i];
      const T sp = sqrt_(T(1) + rho), sm = sqrt_(T(1) - rho);
      const T s = (sp + sm) * T(0.5), t = (sp - sm) * T(0.5);
      out[i] = e;
      out[LS + i] = s * sxi + t * sxj;
      out[2 * LS + i] = t * sxi + s * sxj;
      out[3 * LS + i] = sx2a;
      out[4 * LS + i] = sx2m;
      out[5 * LS + i] = sxixj;
    }
  }
}

// ---- launches ------------------------------------------------------------------------

struct Launch {
  const void *coeffs, *muu, *muv, *su, *sv, *pn, *rule_host;
  void* out;
  int L, S, P, Q, K;
  double cu, ru, cv, rv;
  cudaStream_t stream;
};

// A site's lanes G: whole warps for its L K^2 samples at R a lane, at most a
// CTA; sites a CTA spc: as many as fill kThreads lanes and whose whole blocks
// fit the budget (at least 1); rows a chunk PA: the whole block where it
// fits, else what the budget leaves
template <typename T, int QB, int R>
int launch_instance(const Launch& a, const NodeRule& rule) {
  const long long NS = static_cast<long long>(a.L) * a.K * a.K;
  const long long lanes = (NS + R - 1) / R;
  const int G = static_cast<int>(lanes >= kThreads ? kThreads : 32 * ((lanes + 31) / 32));
  auto bytes = [&](long long spc, long long rows) {
    return static_cast<long long>((spc * rows * QB + spc * NS) * sizeof(T) + 2 * a.K * 8);
  };
  int spc = kThreads / G < a.S ? kThreads / G : a.S;
  while (spc > 1 && bytes(spc, a.P) > kMaxDynSmem) --spc;
  int PA = a.P;
  if (bytes(spc, PA) > kMaxDynSmem) {
    const long long room =
        (kMaxDynSmem - 16LL * a.K) / static_cast<long long>(sizeof(T)) - spc * NS;
    if (room < QB) return static_cast<int>(cudaErrorInvalidValue);
    PA = static_cast<int>(room / (static_cast<long long>(spc) * QB));
  }
  const long long grid = (a.S + spc - 1) / spc;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cheb_gq_kernel<T, QB, R><<<static_cast<unsigned>(grid), spc * G,
                             static_cast<size_t>(bytes(spc, PA)), a.stream>>>(
      static_cast<const T*>(a.coeffs), static_cast<const T*>(a.muu),
      static_cast<const T*>(a.muv), static_cast<const T*>(a.su), static_cast<const T*>(a.sv),
      static_cast<const T*>(a.pn), rule, a.K, static_cast<T*>(a.out), a.L, a.S, a.P, a.Q, G,
      spc, PA, static_cast<T>(a.cu), static_cast<T>(a.ru), static_cast<T>(a.cv),
      static_cast<T>(a.rv));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cheb_gq(const Launch& a, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.K < 1 || a.K > kMaxK || a.Q < 1 || a.Q > kMaxQ || a.P < 1 || a.L < 1 || a.S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.S == 0) return static_cast<int>(cudaSuccess);
  NodeRule rule{};
  std::memcpy(rule.x, a.rule_host, a.K * sizeof(double));
  std::memcpy(rule.w, static_cast<const double*>(a.rule_host) + a.K, a.K * sizeof(double));
  constexpr bool f32 = std::is_same<T, float>::value;
  if (a.Q <= 8) return launch_instance<T, 8, f32 ? 4 : 2>(a, rule);
  if (a.Q <= 16) return launch_instance<T, 16, f32 ? 4 : 2>(a, rule);
  if (a.Q <= 32) return launch_instance<T, 32, f32 ? 2 : 1>(a, rule);
  return launch_instance<T, 64, 1>(a, rule);
}

}  // namespace

// coeffs: the (P, Q, M, N) field stored site major; S = M N sites; the box
// as centre and half-width an axis (cu, ru, cv, rv); rule_host: the K nodes,
// then the K weights, in double for both instances
#define GQMAP_CHEB_GQ(NAME, T)                                                                  \
  extern "C" int NAME(const void* coeffs, const void* muu, const void* muv, const void* su,    \
                      const void* sv, const void* pn, const void* rule_host, void* out, int L,  \
                      int S, int P, int Q, int K, double cu, double ru, double cv, double rv,   \
                      int device, void* stream) {                                              \
    const Launch a{coeffs, muu, muv, su, sv, pn, rule_host, out, L, S, P, Q, K, cu, ru, cv,    \
                   rv,     static_cast<cudaStream_t>(stream)};                                  \
    return launch_cheb_gq<T>(a, device);                                                       \
  }

GQMAP_CHEB_GQ(gqmap_cheb_gq_f32, float)
GQMAP_CHEB_GQ(gqmap_cheb_gq_f64, double)
