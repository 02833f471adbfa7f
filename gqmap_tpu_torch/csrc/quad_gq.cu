// Kernels K10 and K11: the tensor-rule (K^2-point) quadrature of the legacy
// quadratic family (GQMAPConfig.legacy_v1), raw sums. Two variants of each:
// v1 sums the rule point by point; v2, the default, sums it in closed form
// wherever it can (below).
//
// K10 replaces gqmap_tpu/ops/gq.py::gq_accumulate on
// gqmap_tpu/ops/potentials.py::make_node_pot_quadratic, the node prior toward
// an init flow (fu, fv): f(x1, x2) = -((fu - x1)^2 + (fv - x2)^2) / (2 var).
// K11 replaces gq_accumulate on make_edge_pot_truncquad, the truncated-
// quadratic edges: f(x1, x2) = -d^2 / (2 gama) with d = x2 - x1, and 0 where
// |d| > dta. The JAX package runs both as XLA scans (no Pallas kernel); the
// plain versions held against these kernels are
// gqmap_tpu_torch/ops/gq.py::gq_accumulate on the port's potentials.
//
// The rule is the plain version's table (ops/quadrature.build_table): the
// point (r, c) of the K x K grid, flat index r K + c, has XI = x_c, XJ = x_r
// and weight WIWJ = w_r w_c. Under the spectral whitening
// s = (sqrt(1+p) + sqrt(1-p))/2, t = (sqrt(1+p) - sqrt(1-p))/2 each point
// gives z_i = s XI + t XJ, z_j = t XI + s XJ, x1 = sqrt2 o1 z_i + u1,
// x2 = sqrt2 o2 z_j + u2 and fv = WIWJ f(x1, x2), and the kernels write the
// six raw sums Ei, Z1, Z2, Sa, Sm, Sxy. finalize() stays outside. Z1 and Z2
// come from Zc = sum fv XI and Zr = sum fv XJ: Z1 = s Zc + t Zr,
// Z2 = t Zc + s Zr; the scale -1/(2 var) or -1/(2 gama) multiplies the six
// sums once at the end.
//
// v1. The kernels read the K nodes x (rounded to their type, as the plain
// table's XI and XJ are) and, a point, WIWJ and WIWJ times XI XJ,
// XI^2 + XJ^2 - 1 and XI^2 - XJ^2 (kernels/quad_gq.py::rule_values). The
// nodes are Golub-Welsch eigenvalues, symmetric only to rounding
// (x_k + x_{K-1-k} ~ 1e-16, the centre ~ 1e-17), so K3's pairing of a point
// with its mirror would move K11's samples off the plain version's. That
// matters at the cutoff: a sample on the other side of |d| = dta changes Ei
// by WIWJ dta^2 / (2 gama), 50 WIWJ at legacy_v1's gama = 1, dta = 10. So
// K11 forms d as the plain version does on the card, each operation rounded
// once in its order with no contraction into an FMA: s and t from correctly
// rounded roots, z_i = s x_c + t x_r, x1 = o1e z_i + u1 (o1e = o1 sqrt2
// rounded to the type), x2 likewise, d = x2 - x1. The side test |d| > dta is
// then the plain version's, bit for bit. The products s x_c, t x_c are the
// same for every row, and the unrolled instance forms each once. K10 has no
// cutoff: it regroups fu - x1 = (fu - u1 - o1e s x_c) - o1e t x_r, a column
// term less a row term, one operation a point, and its sums contract freely.
// One thread a site (K10) or an edge element (K11), the rule in registers:
// K = 9 (legacy_v1's rule) is a template instance, fully unrolled, whose
// rule is a by-value kernel parameter (the constant bank); any other K runs
// the generic instance, which stages the same values from a device pointer
// into shared memory once a block (rule_instance.cuh).
//
// v2. Both integrands are quadratics in the rule's abscissae (XI, XJ): K10's
// g = (fu - x1)^2 + (fv - x2)^2 everywhere, K11's g = d^2 with
// d = delta + alpha XI + beta XJ wherever no sample is cut. Each of the six
// sums multiplies g by one of 1, XI, XJ, XI^2 + XJ^2 - 1, XI^2 - XJ^2, XI XJ,
// so it is a fixed linear map of g's coefficients c on (1, XI, XJ, XI^2,
// XI XJ, XJ^2): sums = T c with T[i][j] = sum WIWJ (sum monomial i)
// (coefficient monomial j), computed once on the host in float64 from the
// plain table's own points (kernels/quad_gq.py::closed_form_table) and
// passed by value. That is exact algebra on the rule's points, for every K.
// K10 v2 is one thread a site and 36 FMAs: no point loop, one instance for
// every K, bound by its bytes.
// K11 v2 first classifies each edge element. delta = u2 - u1,
// alpha = ((o2e - o1e) sqrt(1+p) - (o2e + o1e) sqrt(1-p)) / 2 and
// beta = ((o2e - o1e) sqrt(1+p) + (o2e + o1e) sqrt(1-p)) / 2 (from the
// roots, not from s and t, whose difference cancels at the |rho| clamp), so
// every sample's exact d lies within |delta| +- (|alpha| + |beta|) max|x|
// of 0. The plain version's rounded d lies within 16 eps (|u1| + |u2| +
// (o1e + o2e)(|s| + |t|) max|x|) of the exact one: its own roundings, those
// of s and t, and this bound's, with room to spare. Beyond that margin
// every sample is inside the cutoff (the closed form, c = (delta^2,
// 2 delta alpha, 2 delta beta, alpha^2, 2 alpha beta, beta^2)) or every one
// is beyond it (zeros); only the rest, "mixed" (a NaN anywhere makes an
// element mixed), runs a point loop, forming each sample's d as v1 does.
// A mixed element's sums are factored by rows: A_r, B_r, C_r = the sums over
// the columns of w_c g, w_c x_c g and w_c x_c^2 g (three FMAs a point; v1
// spends six), then the row's six terms (Ei w_r A, Zc w_r B, Zr w_r x_r A,
// Sa w_r C + w_r (x_r^2 - 1) A, Sm w_r C - w_r x_r^2 A, Sxy w_r x_r B), and
// the rows summed by a pairwise tree over G leaves (16 at K = 9, 32 in the
// runtime-K instance; a leaf past the last row is zero). Two forms run it,
// chosen for each warp by a ballot of its mixed lanes. With at most
// coop_lanes of them, the cooperative form: each half warp (each warp, at
// G = 32) takes one mixed element, a lane a row, and the tree is an xor
// shuffle tree, so a pass sums two elements. With more, the per-lane form:
// each mixed lane its own element, the tree in registers. Every operation of
// both forms is rounded once (__f*_rn) in one order and the tree's adds
// commute, so the two give the same bits: an element's sums depend neither
// on its lane nor on its neighbours' classes, and a shard's block equals
// the whole lattice's bit for bit. K = 9 is an unrolled instance, any other
// K up to kMaxK a runtime-K one; both take the rule (T, and the nodes with
// their weights) as a by-value parameter.
//
// What bounds them on an H100 (kernels/roofline.py k10_work, k11_work): at
// legacy_v1's K = 9 on 376x452, K10 reads 7 values a site and writes 6
// (8.8 MB at L = 1); K11 reads mu, sigma and rho and writes 6 sums an edge
// element (21.8 MB on the (2, 2, 1, M, N) lattice). v1's operations bound
// both (~17 and ~20 a point); v2's bytes bound K10, and K11 where few
// elements are mixed. K10's grid is (sites, L) and it reads the prior
// through its strides, so a shard's block (a view of the whole prior) needs
// no copy; K11's grid is K3's, (sites, D*C*L planes), endpoint 1 plane
// dc % C of the (C, L, M, N) state stacks.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstring>
#include <type_traits>

#include "rule_instance.cuh"

namespace {

constexpr int kThreads = 256;
constexpr double kSqrt2 = 1.41421356237309504880;
constexpr int kRows = 4;  // per-point rows of v1's rule

// Each operation rounded once, never contracted: the plain version's d.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }

// The rule (kernels/quad_gq.py::rule_values): the K nodes, then for each of
// the K^2 points in the table's order WIWJ, WIWJ XI XJ, WIWJ (XI^2 + XJ^2 - 1)
// and WIWJ (XI^2 - XJ^2).
template <typename T, int K>
struct QuadRule {
  static constexpr int kK = K;
  T x[K], w[K * K], wxixj[K * K], wx2a[K * K], wx2m[K * K];
};
template <typename T>
struct QuadRule<T, 0> {  // the generic instance reads the rule from shared memory
  static constexpr int kK = 0;
};

// Kernel parameters live in the constant bank: the K = 9 rule in float64
// (2,664 B) and the other arguments (under 128 B) stay within 4 KB.
static_assert(sizeof(QuadRule<double, 9>) + 128 <= 4096, "rule exceeds parameter space");

// s and t of the spectral whitening, as the plain version forms them, from
// the roots sp = sqrt(1 + p) and sm = sqrt(1 - p)
template <typename T>
struct Whitening {
  T sp, sm, s, t;
  __device__ __forceinline__ explicit Whitening(T p) {
    sp = sqrt_rn(add_rn(T(1), p));
    sm = sqrt_rn(sub_rn(T(1), p));
    s = mul_rn(add_rn(sp, sm), T(0.5));
    t = mul_rn(sub_rn(sp, sm), T(0.5));
  }
};

template <typename T>
struct Sums {
  T e = T(0), zc = T(0), zr = T(0), sa = T(0), sm = T(0), sxy = T(0);

  // a point of f's value -g / scale: weight w, nodes xc (XI) and xr (XJ)
  __device__ __forceinline__ void add(T g, T w, T wxixj, T wx2a, T wx2m, T xc, T xr) {
    const T fv = w * g;
    e += fv;
    zc += fv * xc;
    zr += fv * xr;
    sa += wx2a * g;
    sm += wx2m * g;
    sxy += wxixj * g;
  }

  // the six sums times scale, at element e of the (6, n) output
  __device__ __forceinline__ void write(T* out, size_t e, size_t n, const Whitening<T>& wh,
                                        T scale) const {
    out[e] = scale * this->e;
    out[n + e] = scale * (wh.s * zc + wh.t * zr);
    out[2 * n + e] = scale * (wh.t * zc + wh.s * zr);
    out[3 * n + e] = scale * sa;
    out[4 * n + e] = scale * sm;
    out[5 * n + e] = scale * sxy;
  }
};

// K10's point (r, c): the prior's squared distance (fu - x1)^2 + (fv - x2)^2,
// with a = fu - u1, b = fv - u2, o1s = o1e s and so on
template <typename T>
struct QuadNodePoint {
  T a, b, o1s, o1t, o2s, o2t;
  __device__ __forceinline__ T operator()(T xc, T xr) const {
    const T du = (a - o1s * xc) - o1t * xr;
    const T dv = (b - o2t * xc) - o2s * xr;
    return du * du + dv * dv;
  }
};

// K11's point (r, c): d^2, or 0 where the plain version's d lies beyond dta
template <typename T>
struct TruncQuadPoint {
  T u1, u2, o1e, o2e, dta, s, t;
  __device__ __forceinline__ T operator()(T xc, T xr) const {
    const T zi = add_rn(mul_rn(s, xc), mul_rn(t, xr));
    const T zj = add_rn(mul_rn(t, xc), mul_rn(s, xr));
    const T x1 = add_rn(mul_rn(o1e, zi), u1);
    const T x2 = add_rn(mul_rn(o2e, zj), u2);
    T d = sub_rn(x2, x1);
    d = abs_(d) > dta ? T(0) : d;  // a NaN d stays NaN, as torch.where keeps it
    return d * d;
  }
};

// Every point of the rule: the by-value instance unrolled, or the generic
// one's values in shared memory (K nodes, then kRows rows of K^2).
template <typename T, int K, typename Point>
__device__ __forceinline__ Sums<T> over_rule(const Point& pt, const QuadRule<T, K>& rule,
                                             const T* stab, int k) {
  Sums<T> acc;
  if constexpr (K == 0) {
    const int np = k * k;
    const T* v = stab + k;
    for (int r = 0; r < k; ++r) {
      const T xr = stab[r];
#pragma unroll 4
      for (int c = 0; c < k; ++c) {
        const int i = r * k + c;
        acc.add(pt(stab[c], xr), v[i], v[np + i], v[2 * np + i], v[3 * np + i], stab[c], xr);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < K; ++r) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const int i = r * K + c;
        acc.add(pt(rule.x[c], rule.x[r]), rule.w[i], rule.wxixj[i], rule.wx2a[i],
                rule.wx2m[i], rule.x[c], rule.x[r]);
      }
    }
  }
  return acc;
}

// The generic instance's rule into shared memory, once a block.
template <typename T, int K>
__device__ __forceinline__ void stage_rule(T* stab, const T* tab, int k) {
  if constexpr (K == 0) {
    for (int i = threadIdx.x; i < k + kRows * k * k; i += blockDim.x) stab[i] = tab[i];
    __syncthreads();
  }
}

// K10 v1.
// muu, muv, su, sv, pn: (L, S) sites, S = M N
// prior:                (fu, fv) of site (m, n) at m sm + n sn and + sc
// out:                  (6, L, S)  Ei, Z1, Z2, Sa, Sm, Sxy
// grid:                 (ceil(S / kThreads), L)
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
quad_node_kernel(const T* __restrict__ muu, const T* __restrict__ muv, const T* __restrict__ su,
                 const T* __restrict__ sv, const T* __restrict__ pn, const T* __restrict__ prior,
                 const __grid_constant__ QuadRule<T, K> rule, const T* __restrict__ tab, int k,
                 T* __restrict__ out, int N, int S, int sm, int sn, int sc, T scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stab = reinterpret_cast<T*>(smem_raw);
  stage_rule<T, K>(stab, tab, k);

  const int site = blockIdx.x * kThreads + threadIdx.x;
  if (site >= S) return;
  const size_t e = static_cast<size_t>(blockIdx.y) * S + site;
  const size_t n = static_cast<size_t>(gridDim.y) * S;
  const T* f = prior + static_cast<long long>(site / N) * sm +
               static_cast<long long>(site % N) * sn;
  const Whitening<T> wh(pn[e]);
  const T o1e = su[e] * T(kSqrt2);
  const T o2e = sv[e] * T(kSqrt2);
  const QuadNodePoint<T> pt{f[0] - muu[e], f[sc] - muv[e], o1e * wh.s, o1e * wh.t,
                            o2e * wh.s, o2e * wh.t};
  over_rule<T, K>(pt, rule, stab, k).write(out, e, n, wh, scale);
}

// K11 v1.
// mu, sg:            (C, L, S)     endpoint-1 means / sigmas (plane dc % C)
// u2_in, o2_in, rou: (D*C, L, S)   endpoint-2 means / sigmas, edge correlation
// out:               (6, D*C, L, S)  Ei, Z1, Z2, Sa, Sm, Sxy
// grid:              (ceil(S / kThreads), D*C*L); block y = dc * L + l
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
truncquad_edge_kernel(const T* __restrict__ mu, const T* __restrict__ sg,
                      const T* __restrict__ u2_in, const T* __restrict__ o2_in,
                      const T* __restrict__ rou, const __grid_constant__ QuadRule<T, K> rule,
                      const T* __restrict__ tab, int k, T* __restrict__ out, int C, int L,
                      int S, T dta, T scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stab = reinterpret_cast<T*>(smem_raw);
  stage_rule<T, K>(stab, tab, k);

  const int site = blockIdx.x * kThreads + threadIdx.x;
  if (site >= S) return;
  const int plane = blockIdx.y;  // dc * L + l
  const int dc = plane / L;
  const int plane1 = plane - (dc - dc % C) * L;  // (dc % C) * L + l
  const size_t e = static_cast<size_t>(plane) * S + site;
  const size_t e1 = static_cast<size_t>(plane1) * S + site;
  const size_t n = static_cast<size_t>(gridDim.y) * S;
  const Whitening<T> wh(rou[e]);
  const TruncQuadPoint<T> pt{mu[e1], u2_in[e], mul_rn(sg[e1], T(kSqrt2)),
                             mul_rn(o2_in[e], T(kSqrt2)), dta, wh.s, wh.t};
  over_rule<T, K>(pt, rule, stab, k).write(out, e, n, wh, scale);
}

// v1's launches: the instance the rule selects (rule_instance.cuh), host
// values the K = 9 instance, device values the generic one.
template <typename T>
size_t v1_generic_smem(int K) {
  return (K + kRows * static_cast<size_t>(K) * K) * sizeof(T);
}

template <typename T>
int launch_quad_node(const void* muu, const void* muv, const void* su, const void* sv,
                     const void* pn, const void* prior, const void* rule_host,
                     const void* rule_dev, void* out, int L, int M, int N, int K, int sm, int sn,
                     int sc, double scale, int device, cudaStream_t stream) {
  if (L < 0 || L > 65535 || M < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int S = M * N;
  if (S == 0 || L == 0) return 0;
  const dim3 grid((S + kThreads - 1) / kThreads, L);
  return gqmap::launch_rule_instance<QuadRule, T, 9>(
      rule_host, rule_dev, K, device, v1_generic_smem<T>(K),
      [&](const auto& rule, const T* tab, size_t smem) {
        constexpr int KK = std::decay_t<decltype(rule)>::kK;
        quad_node_kernel<T, KK><<<grid, kThreads, smem, stream>>>(
            static_cast<const T*>(muu), static_cast<const T*>(muv), static_cast<const T*>(su),
            static_cast<const T*>(sv), static_cast<const T*>(pn), static_cast<const T*>(prior),
            rule, tab, K, static_cast<T*>(out), N, S, sm, sn, sc, static_cast<T>(scale));
      });
}

template <typename T>
int launch_truncquad_edge(const void* mu, const void* sg, const void* u2e, const void* o2e,
                          const void* rou, const void* rule_host, const void* rule_dev,
                          void* out, int DC, int C, int L, int S, int K, double dta,
                          double scale, int device, cudaStream_t stream) {
  if (DC * L > 65535 || C < 1 || DC % C != 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0 || DC * L == 0) return 0;
  const dim3 grid((S + kThreads - 1) / kThreads, DC * L);
  return gqmap::launch_rule_instance<QuadRule, T, 9>(
      rule_host, rule_dev, K, device, v1_generic_smem<T>(K),
      [&](const auto& rule, const T* tab, size_t smem) {
        constexpr int KK = std::decay_t<decltype(rule)>::kK;
        truncquad_edge_kernel<T, KK><<<grid, kThreads, smem, stream>>>(
            static_cast<const T*>(mu), static_cast<const T*>(sg), static_cast<const T*>(u2e),
            static_cast<const T*>(o2e), static_cast<const T*>(rou), rule, tab, K,
            static_cast<T*>(out), C, L, S, static_cast<T>(dta), static_cast<T>(scale));
      });
}

// ---- v2 ------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 32;  // K11 v2's nodes by value (kernels/quad_gq.py V2_MAX_K)
constexpr int kSums = 6;
template <typename T>
constexpr T kEps = std::is_same<T, float>::value ? T(FLT_EPSILON) : T(DBL_EPSILON);

// T[i][j] (kernels/quad_gq.py::closed_form_table): sum i of monomial j of g
template <typename T>
struct ClosedForm {
  T t[kSums][kSums];
};

// K11 v2's rule: the closed form, then a node's x_k, w_k, w_k x_k, w_k x_k^2 and
// w_k (x_k^2 - 1) (kernels/quad_gq.py::node_values), and max |x_k|
template <typename T>
struct EdgeRuleV2 {
  ClosedForm<T> cf;
  T x[kMaxK], w[kMaxK], wx[kMaxK], wx2[kMaxK], wx2m1[kMaxK];
  T xmax;
};
static_assert(sizeof(EdgeRuleV2<double>) + 160 <= 4096, "rule exceeds parameter space");

template <typename T>
struct Six {
  T v[kSums];
};

// the six sums (Ei, Zc, Zr, Sa, Sm, Sxy) of g's coefficients c:
// 1, XI, XJ, XI^2, XI XJ, XJ^2
template <typename T>
__device__ __forceinline__ Six<T> closed_form(const ClosedForm<T>& cf, const T (&c)[kSums]) {
  Six<T> r;
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    T acc = cf.t[i][0] * c[0];
#pragma unroll
    for (int j = 1; j < kSums; ++j) acc = fma_rn(cf.t[i][j], c[j], acc);
    r.v[i] = acc;
  }
  return r;
}

// the six sums times scale (Z1, Z2 from Zc, Zr), at element e of (6, n)
template <typename T>
__device__ __forceinline__ void write_sums(T* out, size_t e, size_t n, const Six<T>& r, T s, T t,
                                           T scale) {
  out[e] = mul_rn(scale, r.v[0]);
  out[n + e] = mul_rn(scale, fma_rn(s, r.v[1], mul_rn(t, r.v[2])));
  out[2 * n + e] = mul_rn(scale, fma_rn(t, r.v[1], mul_rn(s, r.v[2])));
  out[3 * n + e] = mul_rn(scale, r.v[3]);
  out[4 * n + e] = mul_rn(scale, r.v[4]);
  out[5 * n + e] = mul_rn(scale, r.v[5]);
}

// K10 v2: the closed form a site.
// muu, muv, su, sv, pn: (L, S) sites, S = M N
// prior:                (fu, fv) of site (m, n) at m sm + n sn and + sc
// out:                  (6, L, S)  Ei, Z1, Z2, Sa, Sm, Sxy
// grid:                 (ceil(S / kThreads), L)
template <typename T>
__global__ void __launch_bounds__(kThreads)
quad_node_v2_kernel(const T* __restrict__ muu, const T* __restrict__ muv,
                    const T* __restrict__ su, const T* __restrict__ sv,
                    const T* __restrict__ pn, const T* __restrict__ prior,
                    const __grid_constant__ ClosedForm<T> cf, T* __restrict__ out, int N, int S,
                    int sm, int sn, int sc, T scale) {
  const int site = blockIdx.x * kThreads + threadIdx.x;
  if (site >= S) return;
  const size_t e = static_cast<size_t>(blockIdx.y) * S + site;
  const size_t n = static_cast<size_t>(gridDim.y) * S;
  const T* f = prior + static_cast<long long>(site / N) * sm +
               static_cast<long long>(site % N) * sn;
  const Whitening<T> wh(pn[e]);
  const T o1e = su[e] * T(kSqrt2);
  const T o2e = sv[e] * T(kSqrt2);
  const T a = f[0] - muu[e];
  const T b = f[sc] - muv[e];
  const T o1s = o1e * wh.s, o1t = o1e * wh.t, o2s = o2e * wh.s, o2t = o2e * wh.t;
  // fu - x1 = a - o1s XI - o1t XJ, fv - x2 = b - o2t XI - o2s XJ
  const T c[kSums] = {a * a + b * b,           T(-2) * (a * o1s + b * o2t),
                      T(-2) * (a * o1t + b * o2s), o1s * o1s + o2t * o2t,
                      T(2) * (o1s * o1t + o2t * o2s), o1t * o1t + o2s * o2s};
  write_sums(out, e, n, closed_form(cf, c), wh.s, wh.t, scale);
}

// A mixed element of K11 v2 as its point loop reads it.
template <typename T>
struct Element {
  T u1, u2, o1e, o2e, s, t;
};

// a row's node values: x_r, w_r, w_r x_r, w_r x_r^2, w_r (x_r^2 - 1)
template <typename T>
struct RowNode {
  T x, w, wx, wx2, wx2m1;
};

template <typename T>
__device__ __forceinline__ RowNode<T> row_node(const EdgeRuleV2<T>& rule, int r) {
  return {rule.x[r], rule.w[r], rule.wx[r], rule.wx2[r], rule.wx2m1[r]};
}

template <typename T>
__device__ __forceinline__ Six<T> add6(const Six<T>& a, const Six<T>& b) {
  Six<T> r;
#pragma unroll
  for (int i = 0; i < kSums; ++i) r.v[i] = add_rn(a.v[i], b.v[i]);
  return r;
}

// Row r of a mixed element: every sample's d as the plain version forms it
// (TruncQuadPoint's operations; sx(c), tx(c) give s x_c, t x_c), g = d^2 or 0
// beyond dta, the column sums A, B, C and the row's six terms.
template <typename T, int K, typename Col>
__device__ __forceinline__ Six<T> mixed_row(const EdgeRuleV2<T>& rule, int k,
                                            const RowNode<T>& row, const Element<T>& el, T dta,
                                            const Col& col) {
  const T sxr = mul_rn(el.s, row.x);
  const T txr = mul_rn(el.t, row.x);
  T A = T(0), B = T(0), C = T(0);
  auto point = [&](int c) {
    T sxc, txc;
    col(c, sxc, txc);
    const T zi = add_rn(sxc, txr);
    const T zj = add_rn(txc, sxr);
    const T x1 = add_rn(mul_rn(el.o1e, zi), el.u1);
    const T x2 = add_rn(mul_rn(el.o2e, zj), el.u2);
    T d = sub_rn(x2, x1);
    d = abs_(d) > dta ? T(0) : d;  // a NaN d stays NaN, as torch.where keeps it
    const T g = mul_rn(d, d);
    A = fma_rn(rule.w[c], g, A);
    B = fma_rn(rule.wx[c], g, B);
    C = fma_rn(rule.wx2[c], g, C);
  };
  if constexpr (K > 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) point(c);
  } else {
    for (int c = 0; c < k; ++c) point(c);
  }
  const T wc = mul_rn(row.w, C);
  return {{mul_rn(row.w, A), mul_rn(row.w, B), mul_rn(row.wx, A), fma_rn(row.wx2m1, A, wc),
           fma_rn(-row.wx2, A, wc), mul_rn(row.wx, B)}};
}

// The leaves of the mixed forms' tree: rows, G of them at K = 9 (kK <= 16), 32 in
// the runtime-K instance
template <int K>
constexpr int kLeaves = K > 0 && K <= 16 ? 16 : 32;

// The pairwise tree over leaves LO .. LO + N - 1: the per-lane form's sums.
template <int LO, int N, typename T, typename Leaf>
__device__ __forceinline__ Six<T> leaf_tree(const Leaf& leaf) {
  if constexpr (N == 1) {
    return leaf(LO);
  } else {
    const Six<T> a = leaf_tree<LO, N / 2, T>(leaf);
    const Six<T> b = leaf_tree<LO + N / 2, N / 2, T>(leaf);
    return add6(a, b);
  }
}

// The per-lane form: one thread sums its own mixed element.
template <typename T, int K>
__device__ __forceinline__ Six<T> per_lane_sums(const EdgeRuleV2<T>& rule, int k,
                                                const Element<T>& el, T dta) {
  constexpr int KC = K > 0 ? K : 1;
  T sx[KC], tx[KC];  // K = 9: each column's s x_c and t x_c once
  if constexpr (K > 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      sx[c] = mul_rn(el.s, rule.x[c]);
      tx[c] = mul_rn(el.t, rule.x[c]);
    }
  }
  auto col = [&](int c, T& a, T& b) {
    if constexpr (K > 0) {
      a = sx[c];
      b = tx[c];
    } else {
      a = mul_rn(el.s, rule.x[c]);
      b = mul_rn(el.t, rule.x[c]);
    }
  };
  const int rows = K > 0 ? K : k;
  auto leaf = [&](int q) -> Six<T> {
    if (q >= rows) return Six<T>{};
    return mixed_row<T, K>(rule, k, row_node(rule, q), el, dta, col);
  };
  return leaf_tree<0, kLeaves<K>, T>(leaf);
}

// K11 v2.
// mu, sg:            (C, L, S)     endpoint-1 means / sigmas (plane dc % C)
// u2_in, o2_in, rou: (D*C, L, S)   endpoint-2 means / sigmas, edge correlation
// out:               (6, D*C, L, S)  Ei, Z1, Z2, Sa, Sm, Sxy
// counts:            null, or 6 counters: elements inside, outside, mixed;
//                    warps with a mixed lane; of those, the warps that ran the
//                    cooperative form and their mixed elements
// grid:              (ceil(S / kThreads), D*C*L); block y = dc * L + l
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
truncquad_edge_v2_kernel(const T* __restrict__ mu, const T* __restrict__ sg,
                         const T* __restrict__ u2_in, const T* __restrict__ o2_in,
                         const T* __restrict__ rou, const __grid_constant__ EdgeRuleV2<T> rule,
                         int k, T* __restrict__ out, unsigned long long* __restrict__ counts,
                         int C, int L, int S, T dta, T scale, int coop_lanes) {
  enum { kNone, kInside, kOutside, kMixed };
  const int lane = threadIdx.x & 31;
  const int site = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = site < S;  // every lane stays for the warp's ballot and shuffles
  const int plane = blockIdx.y;  // dc * L + l
  const int dc = plane / L;
  const int plane1 = plane - (dc - dc % C) * L;  // (dc % C) * L + l
  const size_t e = static_cast<size_t>(plane) * S + site;
  const size_t e1 = static_cast<size_t>(plane1) * S + site;
  const size_t n = static_cast<size_t>(gridDim.y) * S;

  Element<T> el{T(0), T(0), T(0), T(0), T(0), T(0)};
  T p = T(0);
  if (valid) {
    el.u1 = mu[e1];
    el.u2 = u2_in[e];
    el.o1e = mul_rn(sg[e1], T(kSqrt2));
    el.o2e = mul_rn(o2_in[e], T(kSqrt2));
    p = rou[e];
  }
  const Whitening<T> wh(p);
  el.s = wh.s;
  el.t = wh.t;

  // d = delta + alpha XI + beta XJ; the class from its reach over the grid
  const T delta = el.u2 - el.u1;
  const T dn = el.o2e - el.o1e, ds = el.o2e + el.o1e;
  const T alpha = (dn * wh.sp - ds * wh.sm) * T(0.5);
  const T beta = (dn * wh.sp + ds * wh.sm) * T(0.5);
  const T reach = (abs_(alpha) + abs_(beta)) * rule.xmax;
  const T margin = T(16) * kEps<T> *
                   (abs_(el.u1) + abs_(el.u2) +
                    (abs_(el.o1e) + abs_(el.o2e)) * (abs_(el.s) + abs_(el.t)) * rule.xmax);
  const T ad = abs_(delta);
  int cls = kNone;
  if (valid) cls = ad + reach + margin < dta ? kInside
                                             : (ad - reach - margin > dta ? kOutside : kMixed);
  if (cls == kInside) {
    const T c[kSums] = {delta * delta, T(2) * delta * alpha, T(2) * delta * beta,
                        alpha * alpha, T(2) * alpha * beta, beta * beta};
    write_sums(out, e, n, closed_form(rule.cf, c), el.s, el.t, scale);
  } else if (cls == kOutside) {
    write_sums(out, e, n, Six<T>{}, el.s, el.t, scale);
  }

  const unsigned mixed = __ballot_sync(kFull, cls == kMixed);
  const int n_mixed = __popc(mixed);
  const bool coop = n_mixed > 0 && n_mixed <= coop_lanes;
  if (counts != nullptr) {
    const int n_in = __popc(__ballot_sync(kFull, cls == kInside));
    const int n_out = __popc(__ballot_sync(kFull, cls == kOutside));
    if (lane == 0) {
      atomicAdd(counts, static_cast<unsigned long long>(n_in));
      atomicAdd(counts + 1, static_cast<unsigned long long>(n_out));
      atomicAdd(counts + 2, static_cast<unsigned long long>(n_mixed));
      atomicAdd(counts + 3, static_cast<unsigned long long>(n_mixed > 0));
      atomicAdd(counts + 4, static_cast<unsigned long long>(coop));
      atomicAdd(counts + 5, static_cast<unsigned long long>(coop ? n_mixed : 0));
    }
  }
  if (n_mixed == 0) return;

  if (!coop) {  // the per-lane form
    if (cls == kMixed) write_sums(out, e, n, per_lane_sums<T, K>(rule, k, el, dta), el.s, el.t,
                                  scale);
    return;
  }

  // The cooperative form: a group of G lanes an element, lane q of a group
  // its row q (zero past the last row), the rows summed by an xor tree
  constexpr int G = kLeaves<K>;
  const int q = lane & (G - 1);
  const int group = lane / G;
  const int rows = K > 0 ? K : k;
  const RowNode<T> row = row_node(rule, q < rows ? q : 0);
  unsigned left = mixed;
  while (left != 0) {
    int src[32 / G];
#pragma unroll
    for (int h = 0; h < 32 / G; ++h) {
      src[h] = left != 0 ? __ffs(left) - 1 : -1;
      left &= left - 1;
    }
    const int mine = src[group];
    const int from = mine >= 0 ? mine : src[0];
    const Element<T> of{__shfl_sync(kFull, el.u1, from), __shfl_sync(kFull, el.u2, from),
                        __shfl_sync(kFull, el.o1e, from), __shfl_sync(kFull, el.o2e, from),
                        __shfl_sync(kFull, el.s, from), __shfl_sync(kFull, el.t, from)};
    auto col = [&](int c, T& a, T& b) {
      a = mul_rn(of.s, rule.x[c]);
      b = mul_rn(of.t, rule.x[c]);
    };
    Six<T> v = q < rows ? mixed_row<T, K>(rule, k, row, of, dta, col) : Six<T>{};
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      Six<T> o;
#pragma unroll
      for (int i = 0; i < kSums; ++i) o.v[i] = __shfl_xor_sync(kFull, v.v[i], off);
      v = add6(v, o);
    }
    if (q == 0 && mine >= 0) write_sums(out, e - lane + mine, n, v, of.s, of.t, scale);
  }
}

template <typename T>
int launch_quad_node_v2(const void* muu, const void* muv, const void* su, const void* sv,
                        const void* pn, const void* prior, const void* table, void* out, int L,
                        int M, int N, int sm, int sn, int sc, double scale, int device,
                        cudaStream_t stream) {
  if (L < 0 || L > 65535 || M < 0 || N < 0 || table == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int S = M * N;
  if (S == 0 || L == 0) return 0;
  ClosedForm<T> cf;
  std::memcpy(&cf, table, sizeof cf);
  const dim3 grid((S + kThreads - 1) / kThreads, L);
  quad_node_v2_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(muu), static_cast<const T*>(muv), static_cast<const T*>(su),
      static_cast<const T*>(sv), static_cast<const T*>(pn), static_cast<const T*>(prior), cf,
      static_cast<T*>(out), N, S, sm, sn, sc, static_cast<T>(scale));
  return static_cast<int>(cudaGetLastError());
}

// table: the 36 values of T; nodes: the 5 K node values; the K = 9 instance
// unless generic
template <typename T>
int launch_truncquad_edge_v2(const void* mu, const void* sg, const void* u2e, const void* o2e,
                             const void* rou, const void* table, const void* nodes, void* out,
                             void* counts, int DC, int C, int L, int S, int K, int generic,
                             int coop_lanes, double dta, double scale, int device,
                             cudaStream_t stream) {
  if (DC * L > 65535 || C < 1 || DC % C != 0 || S < 0 || K < 2 || K > kMaxK ||
      table == nullptr || nodes == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S == 0 || DC * L == 0) return 0;
  EdgeRuleV2<T> rule;
  std::memset(&rule, 0, sizeof rule);
  std::memcpy(&rule.cf, table, sizeof rule.cf);
  const T* v = static_cast<const T*>(nodes);
  for (int i = 0; i < K; ++i) {
    rule.x[i] = v[i];
    rule.w[i] = v[K + i];
    rule.wx[i] = v[2 * K + i];
    rule.wx2[i] = v[3 * K + i];
    rule.wx2m1[i] = v[4 * K + i];
    const T ax = v[i] < T(0) ? -v[i] : v[i];
    if (ax > rule.xmax) rule.xmax = ax;
  }
  const dim3 grid((S + kThreads - 1) / kThreads, DC * L);
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(mu), static_cast<const T*>(sg), static_cast<const T*>(u2e),
        static_cast<const T*>(o2e), static_cast<const T*>(rou), rule, K, static_cast<T*>(out),
        static_cast<unsigned long long*>(counts), C, L, S, static_cast<T>(dta),
        static_cast<T>(scale), coop_lanes);
  };
  if (K == 9 && !generic)
    go(truncquad_edge_v2_kernel<T, 9>);
  else
    go(truncquad_edge_v2_kernel<T, 0>);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define GQMAP_QUAD_NODE(NAME, T)                                                              \
  extern "C" int NAME(const void* muu, const void* muv, const void* su, const void* sv,       \
                      const void* pn, const void* prior, const void* rule_host,               \
                      const void* rule_dev, void* out, int L, int M, int N, int K, int sm,    \
                      int sn, int sc, double scale, int device, void* stream) {               \
    return launch_quad_node<T>(muu, muv, su, sv, pn, prior, rule_host, rule_dev, out, L, M,   \
                               N, K, sm, sn, sc, scale, device,                               \
                               static_cast<cudaStream_t>(stream));                            \
  }

#define GQMAP_TRUNCQUAD_EDGE(NAME, T)                                                         \
  extern "C" int NAME(const void* mu, const void* sg, const void* u2e, const void* o2e,      \
                      const void* rou, const void* rule_host, const void* rule_dev,          \
                      void* out, int DC, int C, int L, int S, int K, double dta,             \
                      double scale, int device, void* stream) {                              \
    return launch_truncquad_edge<T>(mu, sg, u2e, o2e, rou, rule_host, rule_dev, out, DC, C,  \
                                    L, S, K, dta, scale, device,                             \
                                    static_cast<cudaStream_t>(stream));                      \
  }

#define GQMAP_QUAD_NODE_V2(NAME, T)                                                           \
  extern "C" int NAME(const void* muu, const void* muv, const void* su, const void* sv,       \
                      const void* pn, const void* prior, const void* table, void* out, int L, \
                      int M, int N, int sm, int sn, int sc, double scale, int device,         \
                      void* stream) {                                                         \
    return launch_quad_node_v2<T>(muu, muv, su, sv, pn, prior, table, out, L, M, N, sm, sn,   \
                                  sc, scale, device, static_cast<cudaStream_t>(stream));      \
  }

#define GQMAP_TRUNCQUAD_EDGE_V2(NAME, T)                                                      \
  extern "C" int NAME(const void* mu, const void* sg, const void* u2e, const void* o2e,       \
                      const void* rou, const void* table, const void* nodes, void* out,       \
                      void* counts, int DC, int C, int L, int S, int K, int generic,          \
                      int coop_lanes, double dta, double scale, int device, void* stream) {   \
    return launch_truncquad_edge_v2<T>(mu, sg, u2e, o2e, rou, table, nodes, out, counts, DC,  \
                                       C, L, S, K, generic, coop_lanes, dta, scale, device,   \
                                       static_cast<cudaStream_t>(stream));                    \
  }

GQMAP_QUAD_NODE(gqmap_quad_node_gq_f32, float)
GQMAP_QUAD_NODE(gqmap_quad_node_gq_f64, double)
GQMAP_TRUNCQUAD_EDGE(gqmap_truncquad_edge_gq_f32, float)
GQMAP_TRUNCQUAD_EDGE(gqmap_truncquad_edge_gq_f64, double)
GQMAP_QUAD_NODE_V2(gqmap_quad_node_gq_v2_f32, float)
GQMAP_QUAD_NODE_V2(gqmap_quad_node_gq_v2_f64, double)
GQMAP_TRUNCQUAD_EDGE_V2(gqmap_truncquad_edge_gq_v2_f32, float)
GQMAP_TRUNCQUAD_EDGE_V2(gqmap_truncquad_edge_gq_v2_f64, double)
