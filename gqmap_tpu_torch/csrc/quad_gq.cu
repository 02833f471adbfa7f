// Kernels K10 and K11: the tensor-rule (K^2-point) quadrature of the legacy
// quadratic family (GQMAPConfig.legacy_v1), raw sums.
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
// six raw sums Ei, Z1, Z2, Sa, Sm, Sxy. finalize() stays in torch. The
// kernels read the K nodes x (rounded to their type, as the plain table's
// XI and XJ are) and, a point, WIWJ and WIWJ times XI XJ, XI^2 + XJ^2 - 1
// and XI^2 - XJ^2 (kernels/quad_gq.py::rule_values). Z1 and Z2 come from
// Zc = sum fv XI and Zr = sum fv XJ: Z1 = s Zc + t Zr, Z2 = t Zc + s Zr; the
// scale -1/(2 var) or -1/(2 gama) multiplies the six sums once at the end.
//
// The nodes are Golub-Welsch eigenvalues, symmetric only to rounding
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
//
// What bounds them on an H100 (kernels/roofline.py k10_work, k11_work): at
// legacy_v1's K = 9 on 376x452, K10 reads 7 values a site and writes 6
// (8.8 MB at L = 1) and does ~17 operations a point (13.8e6 points); K11
// reads mu, sigma and rho and writes 6 sums an edge element (21.8 MB on the
// (2, 2, 1, M, N) lattice) and does ~20 operations a point (55e6 points):
// operations bound both. The design: one thread a site (K10) or an edge
// element (K11), the rule in registers, each input read once and each sum
// written once. K = 9 (legacy_v1's rule) is a template instance, fully
// unrolled, whose rule is a by-value kernel parameter: it sits in the
// constant bank and feeds the operations with no load. Any other K runs the
// generic instance, which stages the same values from a device pointer into
// shared memory once a block. K10's grid is (sites, L) and it reads the prior
// through its strides, so a shard's block (a view of the whole prior) needs
// no copy; K11's grid is K3's, (sites, D*C*L planes), endpoint 1 plane
// dc % C of the (C, L, M, N) state stacks.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr double kSqrt2 = 1.41421356237309504880;
constexpr int kMaxSharedBytes = 48 * 1024;  // static launch limit without opt-in
constexpr int kRows = 4;                    // per-point rows of the rule

// Each operation rounded once, never contracted: the plain version's d.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
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

// s and t of the spectral whitening, as the plain version forms them
template <typename T>
struct Whitening {
  T s, t;
  __device__ __forceinline__ explicit Whitening(T p) {
    const T sp = sqrt_rn(add_rn(T(1), p));
    const T sm = sqrt_rn(sub_rn(T(1), p));
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

// K10.
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

// K11.
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

// The rule: the host values (rule_host) select the K = 9 instance, the
// device values (rule_dev) the generic one; exactly one is given.
template <typename T>
struct RuleArg {
  const void* host;
  const void* dev;
  int K;
  bool valid() const { return K >= 2 && (host == nullptr) != (dev == nullptr); }
  size_t smem() const {
    return host == nullptr ? (K + kRows * static_cast<size_t>(K) * K) * sizeof(T) : 0;
  }
};

// Launch `go(rule, tab, smem)` on the instance the rule selects.
template <typename T, typename Go>
int dispatch(const RuleArg<T>& r, int device, Go go) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!r.valid() || r.smem() > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (r.dev != nullptr) {
    go(QuadRule<T, 0>{}, static_cast<const T*>(r.dev), r.smem());
  } else if (r.K == 9) {
    QuadRule<T, 9> rule;
    std::memcpy(&rule, r.host, sizeof rule);
    go(rule, static_cast<const T*>(nullptr), size_t(0));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_quad_node(const void* muu, const void* muv, const void* su, const void* sv,
                     const void* pn, const void* prior, const RuleArg<T>& r, void* out, int L,
                     int M, int N, int sm, int sn, int sc, double scale, int device,
                     cudaStream_t stream) {
  if (L < 0 || L > 65535 || M < 0 || N < 0 || !r.valid())
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = M * N;
  if (S == 0 || L == 0) return 0;
  const dim3 grid((S + kThreads - 1) / kThreads, L);
  return dispatch<T>(r, device, [&](const auto& rule, const T* tab, size_t smem) {
    constexpr int K = std::decay_t<decltype(rule)>::kK;
    quad_node_kernel<T, K><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(muu), static_cast<const T*>(muv), static_cast<const T*>(su),
        static_cast<const T*>(sv), static_cast<const T*>(pn), static_cast<const T*>(prior),
        rule, tab, r.K, static_cast<T*>(out), N, S, sm, sn, sc, static_cast<T>(scale));
  });
}

template <typename T>
int launch_truncquad_edge(const void* mu, const void* sg, const void* u2e, const void* o2e,
                          const void* rou, const RuleArg<T>& r, void* out, int DC, int C, int L,
                          int S, double dta, double scale, int device, cudaStream_t stream) {
  if (DC * L > 65535 || C < 1 || DC % C != 0 || S < 0 || !r.valid())
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0 || DC * L == 0) return 0;
  const dim3 grid((S + kThreads - 1) / kThreads, DC * L);
  return dispatch<T>(r, device, [&](const auto& rule, const T* tab, size_t smem) {
    constexpr int K = std::decay_t<decltype(rule)>::kK;
    truncquad_edge_kernel<T, K><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(mu), static_cast<const T*>(sg), static_cast<const T*>(u2e),
        static_cast<const T*>(o2e), static_cast<const T*>(rou), rule, tab, r.K,
        static_cast<T*>(out), C, L, S, static_cast<T>(dta), static_cast<T>(scale));
  });
}

}  // namespace

#define GQMAP_QUAD_NODE(NAME, T)                                                               \
  extern "C" int NAME(const void* muu, const void* muv, const void* su, const void* sv,        \
                      const void* pn, const void* prior, const void* rule_host,                \
                      const void* rule_dev, void* out, int L, int M, int N, int K, int sm,     \
                      int sn, int sc, double scale, int device, void* stream) {                \
    return launch_quad_node<T>(muu, muv, su, sv, pn, prior,                                    \
                               RuleArg<T>{rule_host, rule_dev, K}, out, L, M, N, sm, sn, sc,   \
                               scale, device, static_cast<cudaStream_t>(stream));              \
  }

#define GQMAP_TRUNCQUAD_EDGE(NAME, T)                                                          \
  extern "C" int NAME(const void* mu, const void* sg, const void* u2e, const void* o2e,       \
                      const void* rou, const void* rule_host, const void* rule_dev,           \
                      void* out, int DC, int C, int L, int S, int K, double dta,              \
                      double scale, int device, void* stream) {                               \
    return launch_truncquad_edge<T>(mu, sg, u2e, o2e, rou,                                     \
                                    RuleArg<T>{rule_host, rule_dev, K}, out, DC, C, L, S, dta, \
                                    scale, device, static_cast<cudaStream_t>(stream));         \
  }

GQMAP_QUAD_NODE(gqmap_quad_node_gq_f32, float)
GQMAP_QUAD_NODE(gqmap_quad_node_gq_f64, double)
GQMAP_TRUNCQUAD_EDGE(gqmap_truncquad_edge_gq_f32, float)
GQMAP_TRUNCQUAD_EDGE(gqmap_truncquad_edge_gq_f64, double)
