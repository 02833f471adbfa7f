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
//
// Variant "v2" (float32; code 1; kernels/cheb_gq.resolve_variant picks it
// where it takes the shape): 88% of the operations are the contraction, and
// per site it is one matrix product that reuses a 6 KB block for 243
// samples, so it goes to the tensor cores. Per site S = T_v . C^T: the
// (samples x QB) v-basis times the (QB x P) transposed block, then
// f_j = (sum_a T_a(u'_j) S[j, a] + sum_{a >= 1} T_a(u'_j) C[a, 0]) + C[0, 0],
// v1's order: S[j, a] is v1's row sum over b >= 1 (column 0 of C is zero in
// the operand), column 0 is summed apart on the FMA pipe and C[0, 0] added
// last. One TF32 product (10 mantissa bits) puts the error 400-900 times the
// plain version's, so each operand is split, x = hi + lo, hi rounded to TF32
// (to nearest, ties away: cvt.rna's rounding, by adding half an ulp and
// masking) and lo = x - hi (exact) truncated to TF32, and S = lo.hi + hi.lo
// + hi.hi, the cross terms of every k-step first, into one accumulator
// (3xTF32: as accurate as two accumulators on tests/test_torch_cheb_gq.py's
// transcription, which holds it to the f64 golden, with 8 fewer adds a row
// and n-tile). Bound: 3 x 2PQ tensor-core operations a sample at 495 TFLOP/s
// (0.77 ms at full_mixture's 96 x 16) beside the rest at 67 TFLOP/s
// (kernels/roofline.k5_work(tensor_cores=True)).
// * wgmma, not mma.sync: on an H100 4 TF32 mma.sync take 26.7 cycles of a
//   sub-partition and the FMAs around them add to that rather than overlap
//   (tc_bench.py), so the FMA-pipe work (the bases, the outer sum, column 0)
//   and the products were serial. wgmma.m64nNk8 (A from registers
//   in m16n8k8's layout, a warp's 16 rows; B from shared memory) runs
//   asynchronously; N = 32, 64 or 96 u-degrees (the fewest that hold P):
//   a dependent wgmma costs its warpgroup 76-112 cycles (tc_bench.py), so
//   fewer, wider ones a unit (3 KS a chunk; 6 at 96 x 16) beat many narrow
//   ones;
// * warp specialisation, one CTA an SM, a site a stage: warps 0-7 (two
//   warpgroups) take the site's units of 64 samples in turn and run the
//   products and the outer sums (lane t of a quad holds u-degrees a = 8n + 2t
//   and 8n + 2t + 1 of each n-tile, so T_a(u') walks two chains T_{a+8} = 2
//   T_8 T_a - T_{a-8} from T_{2t}, T_{2t+1}, T_{8-2t}, T_{7-2t}; the quad's
//   sums by an xor tree); warps 8-11 compute each sample's box point and its
//   bases T_b(v'), b < QB, and T_a(u'), a <= 8, by the three-term
//   recurrence, two samples a thread at once; warps 12-15 split the block
//   into hi and lo B operands (K-major core matrices of 8 x 16 bytes) with
//   column 0 and C[0, 0] apart, and then run v1's reduction (the f values in
//   shared memory, a warp a component, 32 lanes over the K^2 points, the
//   fixed xor tree) two stages behind. Double buffers pass between them on
//   mbarriers (full, empty), the components' whitening a stage ahead (its
//   state loaded two ahead);
// * the blocks: a site's block is one contiguous run of the site-major field,
//   brought into a ring of 3 (or 2) raw buffers by one bulk asynchronous copy
//   (cp.async.bulk, completing on an mbarrier), issued `stages` sites ahead.
// A site's sums depend only on its state and block (a row of a product
// depends on its own A row only; fixed units, chains and trees; no atomics),
// so a shard's block is bit for bit the whole lattice's, and a NaN query
// reaches only its own rows. Instances QB in {8, 16, 32} x N in {32, 64,
// 96}. Shared memory: up to kV2MaxSmem (one CTA an SM), set once an instance
// and device at its first launch (the eager sweeps before a graph capture
// launch it first).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
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

// ---- variant "v2": the contraction on the tensor cores (float32) ---------------------

constexpr int kV2MmaWarps = 8;   // two warpgroups: the products
constexpr int kV2HelpWarps = 8;  // the samples' bases, the block's split, the six sums
constexpr int kV2MmaThreads = 32 * kV2MmaWarps;
constexpr int kV2HelpThreads = 32 * kV2HelpWarps;
constexpr int kV2Threads = kV2MmaThreads + kV2HelpThreads;
constexpr int kV2MaxSmem = 227 * 1024;  // one CTA an SM
constexpr int kV2MaxK = 16;             // the rule's point table in shared memory
constexpr int kV2MaxL = 32;             // a helper thread a component
constexpr int kMaxDevices = 64;

// A CTA's shared memory, in bytes from its start (kernels/cheb_gq.v2_layout
// mirrors it): the mbarriers (the raw ring's, two full, two empty); the
// rule's point table; eight slots of the components' whitening; the raw
// ring; two buffers (128-byte aligned) of a site's split B operands (per
// chunk of N u-degrees and k-step, hi then lo: N x 8 TF32 values as N / 8 x
// 2 core matrices of 8 rows of 16 bytes, K-major), column 0 (a < N NC),
// C[0, 0], its samples' v-basis (QB), u-basis seeds (16) and 2 T_8(u'), and
// their f
struct V2Smem {
  size_t pts, coef, raw, buf, bufsize, bmat, col0, c00, tv, tu, tu8, f, total;
  __host__ __device__ V2Smem(int K, int L, int P, int Q, int QB, int N, int NC, int NSP,
                             int stages) {
    pts = 64;
    coef = pts + static_cast<size_t>(K) * K * 32;
    raw = coef + static_cast<size_t>(8) * L * 32;
    buf = (raw + static_cast<size_t>(stages) * P * Q * 4 + 127) / 128 * 128;
    bmat = 0;  // the rest relative to a buffer
    col0 = bmat + static_cast<size_t>(NC) * (QB / 8) * N * 64;
    c00 = col0 + static_cast<size_t>(NC) * N * 4;
    tv = c00 + 16;
    tu = tv + static_cast<size_t>(NSP) * QB * 4;
    tu8 = tu + static_cast<size_t>(NSP) * 64;
    f = tu8 + static_cast<size_t>(NSP) * 4;
    bufsize = (f + static_cast<size_t>(NSP) * 4 + 127) / 128 * 128;
    total = buf + 2 * bufsize;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// wait for the phase of `parity` to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// one thread: `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory into shared memory, completing on `bar`; the CTA's
// reads of the buffer come before it (a barrier, then the proxy fence)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// x = hi + lo in TF32: hi = x to 10 mantissa bits, to nearest with ties away
// from zero (cvt.rna's rounding, by adding half an ulp and masking), lo = x -
// hi (exact) truncated to TF32 (cvt.rz); a NaN x gives a NaN lo, so its row
// of the product is NaN
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// a shared-memory matrix descriptor of wgmma: no swizzle, K-major core
// matrices of 8 rows x 16 bytes, `lbo` bytes between the two along K and
// `sbo` bytes between 8-row groups along N
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3ffffu) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3ffffu) >> 4) << 32);
}

// d (64 x N of the warpgroup: this thread's N / 2) (+)= A (64 x 8, this warp's
// 16 rows in registers, m16n8k8's layout) . B (8 x N, shared memory) on the
// tensor cores, asynchronously; `accumulate` 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate);
template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48], const uint32_t (&a)[4],
                                               uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// the `threads` threads of named barrier `id` (0 is __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait for the warpgroup's wgmmas; the accumulators are then read, so the
// compiler may not move their reads above the wait
template <int D>
__device__ __forceinline__ void wgmma_wait_all(float (&d)[D]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int i = 0; i < D; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// coeffs: (S, P, Q) site major, 16-byte aligned, P Q a multiple of 4
// grid:   persistent, one CTA an SM; CTA b takes the sites b, b + gridDim.x,
//         ... (stage c: the c-th of them). Warps 0..7 (two warpgroups) run
//         the products, warps 8..15 the rest, a stage ahead and two behind:
//         double buffers handed over by mbarriers (full: the helpers' 256
//         threads arrive, empty: the product warps' 256)
template <int QB, int N>
__global__ void __launch_bounds__(kV2Threads, 1)
cheb_gq_v2_kernel(const float* __restrict__ coeffs, const float* __restrict__ muu,
                  const float* __restrict__ muv, const float* __restrict__ su,
                  const float* __restrict__ sv, const float* __restrict__ pn,
                  const __grid_constant__ NodeRule rule, int K, float* __restrict__ out, int L,
                  int S, int P, int Q, int NC, int U, int NSP, int stages, float cu, float ru,
                  float cv, float rv) {
  constexpr int KS = QB / 8;
  constexpr int RUN = QB / 4;  // a lane's v-degrees of a row: b = t + 4c, c < RUN
  constexpr int CB = N * 32;   // bytes of a chunk's k-step operand, hi or lo
  extern __shared__ __align__(16) unsigned char smem[];
  const V2Smem lay(K, L, P, Q, QB, N, NC, NSP, stages);
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem);  // [stages <= 3]
  uint64_t* full = raw_full + 3;                            // [2]
  uint64_t* empty = raw_full + 5;                           // [2]
  float* pts = reinterpret_cast<float*>(smem + lay.pts);
  float* coef = reinterpret_cast<float*>(smem + lay.coef);
  float* raw = reinterpret_cast<float*>(smem + lay.raw);
  auto at = [&](int b, size_t off) { return smem + lay.buf + b * lay.bufsize + off; };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K2 = K * K, NS = L * K2, PQ = P * Q;
  const int nst = (S - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                  static_cast<int>(gridDim.x);
  const bool helper = warp >= kV2MmaWarps;
  const int h = tid - kV2MmaThreads;  // a helper's index

  // the rule's point constants, each formed in double and rounded once (v1's):
  // x_i, x_j, w_i w_j, x_i x_j, x_i^2 + x_j^2 - 1, x_i^2 - x_j^2
  for (int p = tid; p < K2; p += kV2Threads) {
    const int jx = p / K, ix = p - jx * K;
    const double xi = rule.x[ix], xj = rule.x[jx];
    float* q = pts + 8 * p;
    q[0] = static_cast<float>(xi);
    q[1] = static_cast<float>(xj);
    q[2] = static_cast<float>(rule.w[ix] * rule.w[jx]);
    q[3] = static_cast<float>(xi * xj);
    q[4] = static_cast<float>(xi * xi + xj * xj) - 1.f;
    q[5] = static_cast<float>(xi * xi - xj * xj);
  }
  // helper h < L: component h's state of stage c, and its whitening into
  // coefficient slot c % 8 as v1 forms it per sample: s, t, sqrt2 su, muu,
  // sqrt2 sv, muv
  float state[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // muu, muv, su, sv, rho
  auto load_state = [&](int c) {
    if (helper && h < L && c < nst) {
      const size_t i = static_cast<size_t>(h) * S + blockIdx.x + static_cast<size_t>(c) * gridDim.x;
      state[0] = muu[i];
      state[1] = muv[i];
      state[2] = su[i];
      state[3] = sv[i];
      state[4] = pn[i];
    }
  };
  auto whiten = [&](int c) {
    if (!helper || h >= L) return;
    float* cf = coef + ((c & 7) * L + h) * 8;
    const float sp = sqrtf(1.f + state[4]), sm = sqrtf(1.f - state[4]);
    cf[0] = (sp + sm) * 0.5f;
    cf[1] = (sp - sm) * 0.5f;
    cf[2] = state[2] * static_cast<float>(kSqrt2);
    cf[3] = state[0];
    cf[4] = state[3] * static_cast<float>(kSqrt2);
    cf[5] = state[1];
  };
  load_state(0);
  whiten(0);
  load_state(1);  // in flight
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(raw_full + st, 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(full + b, kV2HelpThreads);
      mbar_init(empty + b, kV2MmaThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (helper) {
    constexpr int kGroup = kV2HelpThreads / 2;  // threads of each helper group
    const int hg = h & (kGroup - 1);
    if (h < kGroup) {
      // group A (warps 8..11): each sample in the box (v1's arithmetic), (0,
      // 0) on the padded rows; its T_b(v'), b < QB, and T_a(u'), a <= 8, by
      // the three-term recurrence, laid out for the lanes: row e holds lane
      // t's run T_{t+4c} at ((t + e) & 3) RUN and its T_{2t}, T_{2t+1},
      // T_{8-2t}, T_{7-2t} at float4 (t + e) & 3 (the rotation keeps a warp's
      // loads free of bank conflicts); two samples a thread at once; then the
      // next stage's whitening
      auto box = [&](const float* cf, int e, float& u, float& v) {
        u = v = 0.f;
        if (e < NS) {
          const int l = e / K2, p = e - l * K2;
          const float* w = cf + l * 8;
          const float xi = pts[8 * p], xj = pts[8 * p + 1];
          const float zi = w[0] * xi + w[1] * xj, zj = w[1] * xi + w[0] * xj;
          const float x1 = w[2] * zi + w[3];
          const float x2 = w[4] * zj + w[5];
          u = clip_keep_nan((x1 - cu) / ru);
          v = clip_keep_nan((x2 - cv) / rv);
        }
      };
      for (int c = 0; c < nst; ++c) {
        const int b = c & 1;
        if (c >= 2) mbar_wait(empty + b, static_cast<uint32_t>(((c >> 1) - 1) & 1));
        const float* cf = coef + (c & 7) * L * 8;
        float* tv = reinterpret_cast<float*>(at(b, lay.tv));
        float4* tu = reinterpret_cast<float4*>(at(b, lay.tu));
        float* tu8 = reinterpret_cast<float*>(at(b, lay.tu8));
        for (int e0 = hg; e0 < NSP; e0 += 2 * kGroup) {
          const int es[2] = {e0, e0 + kGroup};
          float u[2], v[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) box(cf, es[k], u[k], v[k]);
          float T[2][QB], Tu[2][9];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            T[k][0] = 1.f;
            T[k][1] = v[k];
            Tu[k][0] = 1.f;
            Tu[k][1] = u[k];
          }
#pragma unroll
          for (int i = 2; i < QB; ++i)
#pragma unroll
            for (int k = 0; k < 2; ++k) T[k][i] = fmaf(v[k] + v[k], T[k][i - 1], -T[k][i - 2]);
#pragma unroll
          for (int i = 2; i <= 8; ++i)
#pragma unroll
            for (int k = 0; k < 2; ++k) Tu[k][i] = fmaf(u[k] + u[k], Tu[k][i - 1], -Tu[k][i - 2]);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int e = es[k];
            if (e >= NSP) break;
            float* row = tv + static_cast<size_t>(e) * QB;
#pragma unroll
            for (int tt = 0; tt < 4; ++tt) {
              float* dst = row + ((tt + e) & 3) * RUN;
              if constexpr (RUN % 4 == 0) {
#pragma unroll
                for (int i = 0; i < RUN; i += 4)
                  *reinterpret_cast<float4*>(dst + i) =
                      make_float4(T[k][tt + 4 * i], T[k][tt + 4 * i + 4], T[k][tt + 4 * i + 8],
                                  T[k][tt + 4 * i + 12]);
              } else {
                *reinterpret_cast<float2*>(dst) = make_float2(T[k][tt], T[k][tt + 4]);
              }
              tu[4 * static_cast<size_t>(e) + ((tt + e) & 3)] =
                  make_float4(Tu[k][2 * tt], Tu[k][2 * tt + 1], Tu[k][8 - 2 * tt],
                              Tu[k][7 - 2 * tt]);
            }
            tu8[e] = Tu[k][8] + Tu[k][8];
          }
        }
        // the next stage's whitening (its state loaded a stage ago), and the
        // state of the one after it into flight
        whiten(c + 1);
        load_state(c + 2);
        named_barrier(3, kGroup);  // the group's samples read this stage's whitening
        mbar_arrive(full + b);
      }
    } else {
      // group B (warps 12..15): the block, split once into hi and lo B
      // operands: entry (j, ks, n, kb) is row n of chunk j's k-step ks, values
      // B[b][n] = C[N j + n, b] for b = 8 ks + 4 kb .. + 3 (zero at b = 0,
      // past Q and past P), at core matrix (n / 8, kb), row n % 8; then the
      // six sums of the stage two before: a warp a component, v1's lanes and
      // xor tree
      const int hw = hg >> 5;
      auto issue = [&](int c) {  // one thread: stage c's block into raw buffer c % stages
        bulk_load(raw + static_cast<size_t>(c % stages) * PQ,
                  coeffs + (blockIdx.x + static_cast<size_t>(c) * gridDim.x) * PQ,
                  static_cast<uint32_t>(PQ) * 4, raw_full + c % stages);
      };
      auto reduce = [&](int c) {
        const float* fs = reinterpret_cast<const float*>(at(c & 1, lay.f));
        const float* cf = coef + (c & 7) * L * 8;
        const size_t site = blockIdx.x + static_cast<size_t>(c) * gridDim.x;
        const size_t LS = static_cast<size_t>(L) * S;
        for (int l = hw; l < L; l += kGroup / 32) {
          const float* f = fs + l * K2;
          float e = 0.f, sxi = 0.f, sxj = 0.f, sxixj = 0.f, sx2a = 0.f, sx2m = 0.f;
          for (int p = lane; p < K2; p += 32) {
            const float4 q0 = *reinterpret_cast<const float4*>(pts + 8 * p);
            const float2 q1 = *reinterpret_cast<const float2*>(pts + 8 * p + 4);
            const float fv = q0.z * f[p];
            e += fv;
            sxi += q0.x * fv;
            sxj += q0.y * fv;
            sxixj += q0.w * fv;
            sx2a += q1.x * fv;
            sx2m += q1.y * fv;
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
            const size_t i = static_cast<size_t>(l) * S + site;
            const float* w = cf + l * 8;
            out[i] = e;
            out[LS + i] = w[0] * sxi + w[1] * sxj;
            out[2 * LS + i] = w[1] * sxi + w[0] * sxj;
            out[3 * LS + i] = sx2a;
            out[4 * LS + i] = sx2m;
            out[5 * LS + i] = sxixj;
          }
        }
      };
      if (hg == 0)
        for (int c = 0; c < stages && c < nst; ++c) issue(c);
      for (int c = 0; c < nst; ++c) {
        const int b = c & 1;
        if (c >= 2) {  // the product warps are done with stage c - 2's buffer
          mbar_wait(empty + b, static_cast<uint32_t>(((c >> 1) - 1) & 1));
          reduce(c - 2);
        }
        mbar_wait(raw_full + c % stages, static_cast<uint32_t>((c / stages) & 1));
        const float* rs = raw + static_cast<size_t>(c % stages) * PQ;
        unsigned char* bm = at(b, lay.bmat);
        for (int e0 = hg; e0 < NC * KS * N * 2; e0 += 2 * kGroup) {
          float x[2][4];
#pragma unroll
          for (int k = 0; k < 2; ++k) {  // two entries at once: their loads first
            const int e = e0 + k * kGroup;
            const int n = (e >> 1) % N, rest = (e >> 1) / N;
            const int a = N * (rest / KS) + n, b0 = 8 * (rest % KS) + 4 * (e & 1);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int bb = b0 + i;
              x[k][i] = e < NC * KS * N * 2 && a < P && bb > 0 && bb < Q ? rs[a * Q + bb] : 0.f;
            }
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int e = e0 + k * kGroup;
            if (e >= NC * KS * N * 2) break;
            const int kb = e & 1, n = (e >> 1) % N, rest = (e >> 1) / N;
            const int ks = rest % KS, j = rest / KS;
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) split_tf32(x[k][i], hi[i], lo[i]);
            unsigned char* dst =
                bm + (j * KS + ks) * 2 * CB + ((n >> 3) * 2 + kb) * 128 + (n & 7) * 16;
            *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
            *reinterpret_cast<uint4*>(dst + CB) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          }
        }
        float* col0 = reinterpret_cast<float*>(at(b, lay.col0));
        for (int e = hg; e < NC * N; e += kGroup) col0[e] = e >= 1 && e < P ? rs[e * Q] : 0.f;
        if (hg == 0) *reinterpret_cast<float*>(at(b, lay.c00)) = rs[0];
        // the B operands are read by the tensor cores' (async) proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        named_barrier(4, kGroup);  // the raw buffer read
        if (hg == 0 && c + stages < nst) issue(c + stages);
        mbar_arrive(full + b);
      }
      for (int c = nst < 2 ? 0 : nst - 2; c < nst; ++c) {
        mbar_wait(empty + (c & 1), static_cast<uint32_t>((c >> 1) & 1));
        reduce(c);
      }
    }
    return;
  }

  // the products: the CTA's units (64 samples) in order, stage c's c U ..
  // c U + U - 1, warpgroup w taking those congruent to w modulo 2; a warp
  // holds 16 rows of the unit's 64
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, wq = warp & 3;
  for (int c = 0; c < nst; ++c) {
    const int b = c & 1;
    mbar_wait(full + b, static_cast<uint32_t>((c >> 1) & 1));
    const unsigned char* bm = at(b, lay.bmat);
    const float* c0s = reinterpret_cast<const float*>(at(b, lay.col0)) + 2 * t;
    const float c00 = *reinterpret_cast<const float*>(at(b, lay.c00));
    const float* tv = reinterpret_cast<const float*>(at(b, lay.tv));
    const float4* tu = reinterpret_cast<const float4*>(at(b, lay.tu));
    const float* tu8 = reinterpret_cast<const float*>(at(b, lay.tu8));
    float* fsm = reinterpret_cast<float*>(at(b, lay.f));
    for (int q = (wg + static_cast<int>((static_cast<long long>(c) * U) & 1)) & 1; q < U; q += 2) {
      // per row r (g, g + 8): the A fragments, hi and lo; the u-chains k
      // (a = 8 n + 2 t + k): T_a, T_{a-8}, 2 T_8; the two sums
      uint32_t ahi[KS][4], alo[KS][4];
      float tc[2][2], tp[2][2], two8[2], acc[2], acc0[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = q * 64 + wq * 16 + g + 8 * r;
        const float* run = tv + static_cast<size_t>(e) * QB + ((t + e) & 3) * RUN;
        float T[RUN];
        if constexpr (RUN % 4 == 0) {
#pragma unroll
          for (int k = 0; k < RUN; k += 4) {
            const float4 x4 = *reinterpret_cast<const float4*>(run + k);
            T[k] = x4.x;
            T[k + 1] = x4.y;
            T[k + 2] = x4.z;
            T[k + 3] = x4.w;
          }
        } else {
          const float2 x2 = *reinterpret_cast<const float2*>(run);
          T[0] = x2.x;
          T[1] = x2.y;
        }
#pragma unroll
        for (int k = 0; k < RUN; ++k)  // column b = t + 4k: k-step k / 2, register 2 (k & 1) + r
          split_tf32(T[k], ahi[k >> 1][2 * (k & 1) + r], alo[k >> 1][2 * (k & 1) + r]);
        const float4 seeds = tu[4 * static_cast<size_t>(e) + ((t + e) & 3)];
        tc[r][0] = seeds.x;
        tc[r][1] = seeds.y;
        tp[r][0] = seeds.z;
        tp[r][1] = seeds.w;
        two8[r] = tu8[e];
        acc[r] = 0.f;
        acc0[r] = 0.f;
      }
      // chunk j: S = T_v . C^T for u-degrees N j .. N j + N - 1 as 3 KS
      // wgmmas into one accumulator, the cross terms lo.hi and hi.lo of every
      // k-step first, then hi.hi; then its N / 8 n-tiles: lane t's a = 8 nt +
      // 2t + k meet the chains, two FMAs a row for the series, two for column 0
      for (int j = 0; j < NC; ++j) {
        float d[N / 2];
        const unsigned char* bj = bm + j * KS * 2 * CB;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          wgmma_tf32<N>(d, alo[ks], wgmma_desc(bj + ks * 2 * CB, 128, 256), ks > 0);
          wgmma_tf32<N>(d, ahi[ks], wgmma_desc(bj + ks * 2 * CB + CB, 128, 256), 1);
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma_tf32<N>(d, ahi[ks], wgmma_desc(bj + ks * 2 * CB, 128, 256), 1);
        wgmma_commit();
        wgmma_wait_all(d);
#pragma unroll
        for (int n8 = 0; n8 < N / 8; ++n8) {
          const float2 c0 = *reinterpret_cast<const float2*>(c0s + N * j + 8 * n8);
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // D row g + 8r: columns 2t, 2t + 1 of the n-tile
            acc[r] = fmaf(tc[r][0], d[4 * n8 + 2 * r], acc[r]);
            acc[r] = fmaf(tc[r][1], d[4 * n8 + 2 * r + 1], acc[r]);
            acc0[r] = fmaf(tc[r][0], c0.x, acc0[r]);
            acc0[r] = fmaf(tc[r][1], c0.y, acc0[r]);
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const float nx = fmaf(two8[r], tc[r][k], -tp[r][k]);
              tp[r][k] = tc[r][k];
              tc[r][k] = nx;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float a = acc[r], a0 = acc0[r];
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a0 += __shfl_xor_sync(0xffffffffu, a0, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        a0 += __shfl_xor_sync(0xffffffffu, a0, 2);
        const int j = q * 64 + wq * 16 + g + 8 * r;
        if (t == 0 && j < NS) fsm[j] = (a + a0) + c00;
      }
    }
    mbar_arrive(empty + b);
  }
}

// ---- launches ------------------------------------------------------------------------

struct Launch {
  const void *coeffs, *muu, *muv, *su, *sv, *pn, *rule_host;
  void* out;
  int L, S, P, Q, K, variant;
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

// "v2": a site's units U of 64 samples, padded samples NSP, chunks NC of N
// u-degrees (a wgmma's columns: 32, 64 or 96, the fewest that hold P, 96
// past it); a ring of 3 raw buffers, or 2 where 3 do not fit
// (kernels/cheb_gq.v2_layout mirrors this); the grid: one CTA an SM, at most
// one a site
template <int QB, int N>
int launch_v2_n(const Launch& a, const NodeRule& rule, int device) {
  if (device < 0 || device >= kMaxDevices || a.K > kV2MaxK || a.L > kV2MaxL ||
      (a.P * a.Q) % 4 != 0 || (reinterpret_cast<uintptr_t>(a.coeffs) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int NS = a.L * a.K * a.K;
  const int U = (NS + 63) / 64;
  const int NSP = 64 * U;
  const int NC = (a.P + N - 1) / N;
  auto bytes = [&](int stages) {
    return V2Smem(a.K, a.L, a.P, a.Q, QB, N, NC, NSP, stages).total;
  };
  const int stages = bytes(3) <= static_cast<size_t>(kV2MaxSmem) ? 3 : 2;
  const size_t smem = bytes(stages);
  if (smem > static_cast<size_t>(kV2MaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = cheb_gq_v2_kernel<QB, N>;
  // once an instance and device (its first launch, eager, before any graph
  // capture): the shared-memory ceiling and the SM count
  static std::mutex mu;
  static bool ready[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[device]) {
      cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             kV2MaxSmem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return static_cast<int>(err);
      ready[device] = true;
    }
  }
  const int grid = std::min(a.S, sms[device]);
  kernel<<<static_cast<unsigned>(grid), kV2Threads, smem, a.stream>>>(
      static_cast<const float*>(a.coeffs), static_cast<const float*>(a.muu),
      static_cast<const float*>(a.muv), static_cast<const float*>(a.su),
      static_cast<const float*>(a.sv), static_cast<const float*>(a.pn), rule, a.K,
      static_cast<float*>(a.out), a.L, a.S, a.P, a.Q, NC, U, NSP, stages,
      static_cast<float>(a.cu), static_cast<float>(a.ru), static_cast<float>(a.cv),
      static_cast<float>(a.rv));
  return static_cast<int>(cudaGetLastError());
}

template <int QB>
int launch_v2(const Launch& a, const NodeRule& rule, int device) {
  if (a.P <= 32) return launch_v2_n<QB, 32>(a, rule, device);
  if (a.P <= 64) return launch_v2_n<QB, 64>(a, rule, device);
  return launch_v2_n<QB, 96>(a, rule, device);
}

template <typename T>
int launch_cheb_gq(const Launch& a, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.K < 1 || a.K > kMaxK || a.Q < 1 || a.Q > kMaxQ || a.P < 1 || a.L < 1 || a.S < 0 ||
      a.variant < 0 || a.variant > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.S == 0) return static_cast<int>(cudaSuccess);
  NodeRule rule{};
  std::memcpy(rule.x, a.rule_host, a.K * sizeof(double));
  std::memcpy(rule.w, static_cast<const double*>(a.rule_host) + a.K, a.K * sizeof(double));
  constexpr bool f32 = std::is_same<T, float>::value;
  if (a.variant == 1) {  // "v2": float32 only
    if (!f32) return static_cast<int>(cudaErrorInvalidValue);
    if (a.Q <= 8) return launch_v2<8>(a, rule, device);
    if (a.Q <= 16) return launch_v2<16>(a, rule, device);
    if (a.Q <= 32) return launch_v2<32>(a, rule, device);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.Q <= 8) return launch_instance<T, 8, f32 ? 4 : 2>(a, rule);
  if (a.Q <= 16) return launch_instance<T, 16, f32 ? 4 : 2>(a, rule);
  if (a.Q <= 32) return launch_instance<T, 32, f32 ? 2 : 1>(a, rule);
  return launch_instance<T, 64, 1>(a, rule);
}

}  // namespace

// coeffs: the (P, Q, M, N) field stored site major; S = M N sites; the box
// as centre and half-width an axis (cu, ru, cv, rv); rule_host: the K nodes,
// then the K weights, in double for both instances; variant: 0 "v1", 1
// "v2" (float32 only)
#define GQMAP_CHEB_GQ(NAME, T)                                                                  \
  extern "C" int NAME(const void* coeffs, const void* muu, const void* muv, const void* su,    \
                      const void* sv, const void* pn, const void* rule_host, void* out, int L,  \
                      int S, int P, int Q, int K, int variant, double cu, double ru, double cv, \
                      double rv, int device, void* stream) {                                   \
    const Launch a{coeffs, muu, muv, su, sv, pn, rule_host, out, L, S, P, Q, K, variant, cu,   \
                   ru,     cv,  rv,  static_cast<cudaStream_t>(stream)};                        \
    return launch_cheb_gq<T>(a, device);                                                       \
  }

GQMAP_CHEB_GQ(gqmap_cheb_gq_f32, float)
GQMAP_CHEB_GQ(gqmap_cheb_gq_f64, double)
