// Kernels K8 and K9: the sweep's update around the node and edge kernels.
//
// Replaces no Pallas kernel: in the JAX package the whole sweep is one
// jit-compiled program (gqmap_tpu/models/gqmap.py:276, make_sweep), and XLA
// fuses what surrounds its kernels, compute_grads' finalize and neighbour
// assembly (:386-550), one_pass' clamped step and |dmu| / |dsigma| sums
// (:552-570), red-black's two passes and the alpha update, anneal and counter
// (:572-616), into a few loops. The port ran that work as ~140 small eager
// operations a tpu_fast sweep; their plain versions are
// gqmap_tpu_torch/kernels/sweep_update.py::site_update_torch and
// sweep_tail_torch, held against these kernels.
//
// K8, "site update" (one launch a pass; grid (sites / 256, L), one thread a
// lattice site (l, m, n)):
//  1. finalizes the node term from the raw output of whichever node route ran,
//     a template parameter: K1's six cosine mode sums (ops/cosine.py
//     _finalize_mode_sums + ops/gq.py finalize_closed), a GQRaw (K4, K5, K6 or
//     a plain gq_accumulate; ops/gq.py finalize) or K7's GQChainRaw
//     (finalize_chain);
//  2. reads the edge term, again a template parameter: K2's finalized
//     gradients, or raw GQRaw sums (K3, the plain truncated-quadratic sums),
//     finalized here with the edge's entropy sign; at the site's own edges o1
//     is the site's sigma and o2 the neighbour's one row down or one column
//     right, and for the endpoint-2 terms of the edges of the neighbours one
//     row up and one column left o2 is the site's own sigma, with wrap;
//  3. assembles dmuu, dmuv, dsigmau, dsigmav in the plain glue's order,
//     dn + d1[dir 0] + d1[dir 1] + up + left;
//  4. takes the clamped step over the pass's mask (interior, the predicate,
//     the red-black colour) and writes the new muu, muv, sigmau, sigmav, pn
//     and rou into a second buffer, (9, L, M, N): a neighbour's state is read,
//     never the one another thread is writing;
//  5. writes one partial a CTA of the energy and dalpha (over the interior)
//     and of sum |dmuu| and sum |dsigmau| (over the mask), each summed over
//     the CTA's 256 threads by a fixed halving tree: no atomics.
// K9, "sweep tail" (one launch a sweep, one CTA of 512 threads) sums K8's
// partials in a fixed order (512 strided running sums, then a halving tree;
// red-black: |dmu| and |dsigma| of both passes, energy and dalpha of the
// second), takes the alpha step (softmax-natural or simplex projection, after
// alpha_start), the anneal, advances it, applies the predicate to w, T and it
// and writes SweepAux and dalpha; in the segment runner's device loop it also
// writes the trace slot, sets the stop flag and advances the sweep count. Its
// per-component values live in global memory (dalpha in SweepAux, the
// projection's sorted copy in a scratch row after it), so it takes any L.
//
// Arithmetic. The new state is the plain glue's bit for bit on the card, given
// the same kernel outputs, alpha, step and T: every operation is the one
// PyTorch's elementwise kernel for that glue operation runs, in the glue's
// order, each rounded once (the __f*_rn / __d*_rn intrinsics, so nvcc
// contracts nothing). Where Python evaluates "scalar / tensor", PyTorch runs
// tensor.reciprocal() * scalar, and so does this file; Python constants are
// folded in double as Python folds them and rounded to the tensors' type once.
// torch.clamp keeps a NaN and fminf / fmaxf drop one, so the clamp tests for
// NaN first, as PyTorch's clamp kernel does. Only the four sums differ from
// torch.sum, by their order.
//
// What bounds it on an H100: bytes. At tpu_fast's 376x452, L = 3, K8 reads
// K1's six sums, K2's six (2, 2, L, M, N) gradient fields (twice du2 and do2
// at a neighbour, which L2 serves) and the state, and writes the state:
// ~110 MB, ~33 us at 3.35 TB/s; its ~200 operations a site are ~3 us at the
// float32 rate. K9 reads ~32 KB of partials and is latency-bound (one CTA).
// The design is the simple one: one thread a site, every field loaded once
// and coalesced (neighbour reads are shifted rows of the same planes).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;      // K8: sites a CTA
constexpr int kTailThreads = 512;  // K9: its one CTA

// node forms (NODE) and edge forms (EDGE) of K8's instances
constexpr int kModes = 0, kRaw = 1, kChain = 2;
constexpr int kGrads = 0;

// ---- the plain glue's operations, each rounded once to nearest ----------------------

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float log_(float a) { return logf(a); }
__device__ __forceinline__ double log_(double a) { return log(a); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_(double a, double b) { return fmin(a, b); }

// torch.clamp(x, lo, hi) as PyTorch's kernel computes it: a NaN stays
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return isnan(x) ? x : min_(max_(x, lo), hi);
}
// torch.clamp(x, min=lo)
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return isnan(x) ? x : max_(x, lo);
}

// ---- K8 ------------------------------------------------------------------------------

// The plain glue's Python constants, in the tensors' type.
template <typename T>
struct Consts {
  T ku, kv, mhku, hku, hkv;  // K1's sums: pi / (hi - lo) of u and v, -ku / 2, ku / 2, kv / 2
  T inv_pi, sqrt2, const1;   // 1 / pi, sqrt(2), 1 + log(2 pi)
  T es_node, es_edge;        // the entropy scales, NODE = 3 and EDGE = -1
  T minu, maxu, minv, maxv, smin, smax, rmin, rmax, sscale;  // the step's clamps and scale
};
constexpr int kConsts = 19;

template <typename T>
struct SiteArgs {
  const T *muu, *muv, *su, *sv, *pn, *rou;  // the state; rou (2, 2, L, M, N)
  T* out;                                   // the new state, (9, L, M, N)
  const T *alpha, *temp, *step;             // (L,), (), ()
  const bool *interior, *active, *stop;     // (M, N); () or null each
  const T* node[7];                         // the node route's fields, (L, M, N)
  const T* edge[6];                         // the edge route's fields, (2, 2, L, M, N)
  T* part;                                  // (L, G, 4)
  Consts<T> c;
  int L, M, N, colour;  // colour -1: every site; 0: red ((m + n) even); 1: black
};
constexpr int kSitePtrs = 27;

template <typename T>
struct Grads {
  T da, du1, du2, do1, do2, dp, E;
};

// ops/gq.py finalize_closed, cn = entropy_scale * T
template <typename T>
__device__ __forceinline__ Grads<T> closed(T Ef, T dEdu1, T dEdu2, T dEdo1, T dEdo2, T dEdp,
                                           T a, T o1, T o2, T p, T cn, const Consts<T>& c) {
  const T pr = sub(T(1), mul(p, p));
  Grads<T> g;
  g.da = sub(Ef, mul(cn, add(log_(mul(mul(root(pr), o1), o2)), c.const1)));
  g.du1 = mul(a, dEdu1);
  g.du2 = mul(a, dEdu2);
  g.do1 = mul(a, sub(dEdo1, dvd(cn, o1)));
  g.do2 = mul(a, sub(dEdo2, dvd(cn, o2)));
  g.dp = mul(a, add(dEdp, dvd(mul(cn, p), pr)));
  g.E = mul(a, g.da);
  return g;
}

// ops/gq.py finalize of the raw sums (Ei, Z1, Z2, Sa, Sm, Sxy)
template <typename T>
__device__ __forceinline__ Grads<T> finalize(T Ei, T Z1, T Z2, T Sa, T Sm, T Sxy, T a, T o1,
                                             T o2, T p, T cn, const Consts<T>& c) {
  const T pr = sub(T(1), mul(p, p));
  const T sqrtpr = root(pr);
  Grads<T> g;
  // _SQRT2 / (o1 * pr): PyTorch's (o1 * pr).reciprocal() * _SQRT2
  g.du1 = mul(mul(mul(a, sub(Z1, mul(p, Z2))), mul(dvd(T(1), mul(o1, pr)), c.sqrt2)), c.inv_pi);
  g.du2 = mul(mul(mul(a, sub(Z2, mul(p, Z1))), mul(dvd(T(1), mul(o2, pr)), c.sqrt2)), c.inv_pi);
  g.da = sub(mul(Ei, c.inv_pi), mul(cn, add(log_(mul(mul(sqrtpr, o1), o2)), c.const1)));
  const T sm_w = dvd(Sm, sqrtpr);
  g.do1 = dvd(mul(a, sub(mul(add(Sa, sm_w), c.inv_pi), cn)), o1);
  g.do2 = dvd(mul(a, sub(mul(sub(Sa, sm_w), c.inv_pi), cn)), o2);
  g.dp = dvd(mul(a, add(mul(sub(mul(Sxy, T(2)), mul(p, Sa)), c.inv_pi), mul(cn, p))), pr);
  g.E = mul(a, g.da);
  return g;
}

// finalize's du2 and do2 alone: an edge's endpoint-2 terms (they need no o1)
template <typename T>
__device__ __forceinline__ void finalize_end2(T Z1, T Z2, T Sa, T Sm, T a, T o2, T p, T cn,
                                              const Consts<T>& c, T& du2, T& do2) {
  const T pr = sub(T(1), mul(p, p));
  du2 = mul(mul(mul(a, sub(Z2, mul(p, Z1))), mul(dvd(T(1), mul(o2, pr)), c.sqrt2)), c.inv_pi);
  do2 = dvd(mul(a, sub(mul(sub(Sa, dvd(Sm, root(pr))), c.inv_pi), cn)), o2);
}

// the node term's finalized gradients at site i from its route's fields
template <typename T, int NODE>
__device__ __forceinline__ Grads<T> node_grads(const SiteArgs<T>& A, size_t i, T a, T o1, T o2,
                                               T p, T cn) {
  const Consts<T>& c = A.c;
  if constexpr (NODE == kModes) {  // ops/cosine.py _finalize_mode_sums
    const T E0 = A.node[0][i], A1 = A.node[1][i], A2 = A.node[2][i], Aa = A.node[3][i],
            Ab = A.node[4][i], Ax = A.node[5][i];
    const T s1 = mul(o1, c.ku), s2 = mul(o2, c.kv);
    const T dEdo1 = mul(sub(mul(mul(s2, p), Ax), mul(s1, Aa)), c.hku);
    const T dEdo2 = mul(sub(mul(mul(s1, p), Ax), mul(s2, Ab)), c.hkv);
    const T dEdp = mul(mul(mul(s1, T(0.5)), s2), Ax);
    return closed(mul(E0, T(0.5)), mul(A1, c.mhku), mul(A2, c.hkv), dEdo1, dEdo2, dEdp, a, o1,
                  o2, p, cn, c);
  } else if constexpr (NODE == kRaw) {
    return finalize(A.node[0][i], A.node[1][i], A.node[2][i], A.node[3][i], A.node[4][i],
                    A.node[5][i], a, o1, o2, p, cn, c);
  } else {  // ops/gq.py finalize_chain of (Ei, A1, A2, Ci, Cj, Di, Dj)
    const T Ci = A.node[3][i], Cj = A.node[4][i], Di = A.node[5][i], Dj = A.node[6][i];
    const T q = root(add(p, T(1))), r = root(sub(T(1), p));
    const T s = mul(add(q, r), T(0.5)), t = mul(sub(q, r), T(0.5));
    // 1.0 / q: PyTorch's q.reciprocal() * 1.0, and the product by 1 is exact
    const T iq = dvd(T(1), q), ir = dvd(T(1), r);
    const T ds = mul(sub(iq, ir), T(0.25)), dt = mul(add(iq, ir), T(0.25));
    const T dEdo1 = mul(mul(add(mul(s, Ci), mul(t, Cj)), c.sqrt2), c.inv_pi);
    const T dEdo2 = mul(mul(add(mul(t, Di), mul(s, Dj)), c.sqrt2), c.inv_pi);
    const T dEdp = mul(mul(add(mul(o1, add(mul(ds, Ci), mul(dt, Cj))),
                               mul(o2, add(mul(dt, Di), mul(ds, Dj)))),
                           c.sqrt2),
                       c.inv_pi);
    return closed(mul(A.node[0][i], c.inv_pi), mul(A.node[1][i], c.inv_pi),
                  mul(A.node[2][i], c.inv_pi), dEdo1, dEdo2, dEdp, a, o1, o2, p, cn, c);
  }
}

// sums v over the CTA's threads by a halving tree; the total lands in sh[0]
template <typename T, int N>
__device__ __forceinline__ void tree(T (&sh)[4][N], int t) {
#pragma unroll 1
  for (int h = N / 2; h > 0; h >>= 1) {
    if (t < h) {
#pragma unroll
      for (int k = 0; k < 4; ++k) sh[k][t] = add(sh[k][t], sh[k][t + h]);
    }
    __syncthreads();
  }
}

template <typename T, int NODE, int EDGE>
__global__ void __launch_bounds__(kThreads) site_update_kernel(const SiteArgs<T> A) {
  __shared__ T sh[4][kThreads];
  const int t = threadIdx.x;
  const int L = A.L, M = A.M, N = A.N;
  const int S = M * N;
  const int s = blockIdx.x * kThreads + t;
  const int l = blockIdx.y;
  const Consts<T>& c = A.c;
  T v_energy = T(0), v_da = T(0), v_dmu = T(0), v_dsig = T(0);
  if (s < S) {
    const int m = s / N, n = s - m * N;
    const size_t plane = static_cast<size_t>(L) * S;  // one (L, M, N) field
    const size_t site = static_cast<size_t>(l) * S;
    const size_t i = site + s;
    const int up = (m == 0 ? M - 1 : m - 1) * N + n, left = m * N + (n == 0 ? N - 1 : n - 1);
    const int down = (m + 1 == M ? 0 : m + 1) * N + n, right = m * N + (n + 1 == N ? 0 : n + 1);
    const T a = A.alpha[l], temp = *A.temp, step = *A.step;
    const T cn_node = mul(temp, c.es_node), cn_edge = mul(temp, c.es_edge);
    const T su = A.su[i], sv = A.sv[i], pn = A.pn[i];
    const bool interior = A.interior[s];
    const bool live = interior && (A.active == nullptr || *A.active) &&
                      (A.stop == nullptr || !*A.stop);
    const bool mask = live && (A.colour < 0 || ((m + n) & 1) == A.colour);

    const Grads<T> gn = node_grads<T, NODE>(A, i, a, su, sv, pn, cn_node);

    // edges [dir][chan]: the site's own (endpoint 1), and the endpoint-2
    // terms of the edges of the neighbours one row up (dir 0) and one column
    // left (dir 1), which come back to this site
    T du1[2][2], do1[2][2], dp[2][2], da[2][2], E[2][2], du2[2][2], do2[2][2];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const size_t e = (2 * d + ch) * plane + i;
        const size_t en = (2 * d + ch) * plane + site + (d == 0 ? up : left);
        const T sg = ch == 0 ? su : sv;
        if constexpr (EDGE == kGrads) {  // K2's finalized gradients
          da[d][ch] = A.edge[0][e];
          du1[d][ch] = A.edge[1][e];
          do1[d][ch] = A.edge[3][e];
          dp[d][ch] = A.edge[5][e];
          E[d][ch] = mul(a, da[d][ch]);
          du2[d][ch] = A.edge[2][en];
          do2[d][ch] = A.edge[4][en];
        } else {  // raw sums, finalized with the edge's entropy scale
          const T* sgp = ch == 0 ? A.su : A.sv;
          const T o2 = sgp[site + (d == 0 ? down : right)];
          const Grads<T> g = finalize(A.edge[0][e], A.edge[1][e], A.edge[2][e], A.edge[3][e],
                                      A.edge[4][e], A.edge[5][e], a, sg, o2, A.rou[e], cn_edge,
                                      c);
          da[d][ch] = g.da;
          du1[d][ch] = g.du1;
          do1[d][ch] = g.do1;
          dp[d][ch] = g.dp;
          E[d][ch] = g.E;
          finalize_end2(A.edge[1][en], A.edge[2][en], A.edge[3][en], A.edge[4][en], a, sg,
                        A.rou[en], cn_edge, c, du2[d][ch], do2[d][ch]);
        }
      }
    }

    // assemble (models/gqmap.py): dn + d1[0, chan] + d1[1, chan] + up + left
    const T dmuu = add(add(add(add(gn.du1, du1[0][0]), du1[1][0]), du2[0][0]), du2[1][0]);
    const T dmuv = add(add(add(add(gn.du2, du1[0][1]), du1[1][1]), du2[0][1]), du2[1][1]);
    const T dsu = add(add(add(add(gn.do1, do1[0][0]), do1[1][0]), do2[0][0]), do2[1][0]);
    const T dsv = add(add(add(add(gn.do2, do1[0][1]), do1[1][1]), do2[0][1]), do2[1][1]);

    // the clamped step over the mask: where(mask, clamp(x + dx * s, lo, hi), x)
    const T sstep = mul(step, c.sscale);
    T* out = A.out;
    const T muu = A.muu[i], muv = A.muv[i];
    out[0 * plane + i] = mask ? clamp(add(muu, mul(dmuu, step)), c.minu, c.maxu) : muu;
    out[1 * plane + i] = mask ? clamp(add(muv, mul(dmuv, step)), c.minv, c.maxv) : muv;
    out[2 * plane + i] = mask ? clamp(add(su, mul(dsu, sstep)), c.smin, c.smax) : su;
    out[3 * plane + i] = mask ? clamp(add(sv, mul(dsv, sstep)), c.smin, c.smax) : sv;
    out[4 * plane + i] = mask ? clamp(add(pn, mul(gn.dp, step)), c.rmin, c.rmax) : pn;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const size_t e = (2 * d + ch) * plane + i;
        const T r = A.rou[e];
        out[(5 + 2 * d + ch) * plane + i] =
            mask ? clamp(add(r, mul(dp[d][ch], step)), c.rmin, c.rmax) : r;
      }
    }

    if (interior) {
      v_energy = add(add(add(add(gn.E, E[0][0]), E[0][1]), E[1][0]), E[1][1]);
      v_da = add(add(add(add(gn.da, da[0][0]), da[0][1]), da[1][0]), da[1][1]);
    }
    if (mask) {
      v_dmu = fabs(dmuu);
      v_dsig = fabs(dsu);
    }
  }
  sh[0][t] = v_energy;
  sh[1][t] = v_da;
  sh[2][t] = v_dmu;
  sh[3][t] = v_dsig;
  __syncthreads();
  tree(sh, t);
  if (t < 4) A.part[(static_cast<size_t>(l) * gridDim.x + blockIdx.x) * 4 + t] = sh[t][0];
}

template <typename T, int NODE, int EDGE>
cudaError_t launch_site(const SiteArgs<T>& a, cudaStream_t stream) {
  const dim3 grid((a.M * a.N + kThreads - 1) / kThreads, a.L);
  site_update_kernel<T, NODE, EDGE><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// ptrs: kSitePtrs device pointers in SiteArgs' order (muu, muv, su, sv, pn, rou,
// out, alpha, T, step, interior, active, stop, node[7], edge[6], part; null
// for an absent predicate or an unused field); consts: kConsts doubles in
// Consts' order.
template <typename T>
int site_update(const void* ptrs, const void* consts, int node_form, int edge_form, int L,
                int M, int N, int colour, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L < 1 || L > 65535 || M < 1 || N < 1 || static_cast<long long>(M) * N > (1LL << 30) ||
      node_form < kModes || node_form > kChain || edge_form < kGrads || edge_form > kRaw ||
      colour < -1 || colour > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const* p = static_cast<const void* const*>(ptrs);
  const double* k = static_cast<const double*>(consts);
  SiteArgs<T> a;
  a.muu = static_cast<const T*>(p[0]);
  a.muv = static_cast<const T*>(p[1]);
  a.su = static_cast<const T*>(p[2]);
  a.sv = static_cast<const T*>(p[3]);
  a.pn = static_cast<const T*>(p[4]);
  a.rou = static_cast<const T*>(p[5]);
  a.out = static_cast<T*>(const_cast<void*>(p[6]));
  a.alpha = static_cast<const T*>(p[7]);
  a.temp = static_cast<const T*>(p[8]);
  a.step = static_cast<const T*>(p[9]);
  a.interior = static_cast<const bool*>(p[10]);
  a.active = static_cast<const bool*>(p[11]);
  a.stop = static_cast<const bool*>(p[12]);
  for (int q = 0; q < 7; ++q) a.node[q] = static_cast<const T*>(p[13 + q]);
  for (int q = 0; q < 6; ++q) a.edge[q] = static_cast<const T*>(p[20 + q]);
  a.part = static_cast<T*>(const_cast<void*>(p[26]));
  T* cs = &a.c.ku;
  for (int q = 0; q < kConsts; ++q) cs[q] = static_cast<T>(k[q]);
  a.L = L;
  a.M = M;
  a.N = N;
  a.colour = colour;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int form = 2 * node_form + edge_form;
  switch (form) {
    case 2 * kModes + kGrads: return static_cast<int>(launch_site<T, kModes, kGrads>(a, st));
    case 2 * kModes + kRaw: return static_cast<int>(launch_site<T, kModes, kRaw>(a, st));
    case 2 * kRaw + kGrads: return static_cast<int>(launch_site<T, kRaw, kGrads>(a, st));
    case 2 * kRaw + kRaw: return static_cast<int>(launch_site<T, kRaw, kRaw>(a, st));
    case 2 * kChain + kGrads: return static_cast<int>(launch_site<T, kChain, kGrads>(a, st));
    default: return static_cast<int>(launch_site<T, kChain, kRaw>(a, st));
  }
}

// ---- K9 ------------------------------------------------------------------------------

template <typename T>
struct TailArgs {
  const T *part1, *part2;               // K8's partials, (L, G, 4): red-black's first pass
                                        // (null in Jacobi) and the last pass
  const T *w, *temp, *step;             // (L,), (), ()
  const int* it;                        // ()
  const bool *active, *stop;            // () or null each
  T *w_out, *temp_out;                  // (L,), (); may be w and temp themselves
  int* it_out;                          // (); may be it itself
  T* aux;                               // (3 + 2 L,): energy, ptdmu, ptdsigma, dalpha,
                                        // then L values of scratch
  long long* n;                         // the device loop's sweep count, or null
  bool* stop_out;                       // its stop flag (with n)
  T* bufs;                              // its (3, cap) traces (with n)
  T lr_scale, drate, t_floor, n_interior, tor, w_clip;
  int L, G, alpha_start, anneal_every, its, cap, softmax_mode;
};
constexpr int kTailPtrs = 15;
constexpr int kTailConsts = 6;

// the sum of x[j * 4] over j < count: running sums of a thread's stride, then
// the halving tree; every thread gets the total
template <typename T>
__device__ T block_sum(T (&sh)[kTailThreads], const T* x, int count) {
  const int t = threadIdx.x;
  T acc = T(0);
  for (int j = t; j < count; j += kTailThreads) acc = add(acc, x[static_cast<size_t>(j) * 4]);
  sh[t] = acc;
  __syncthreads();
#pragma unroll 1
  for (int h = kTailThreads / 2; h > 0; h >>= 1) {
    if (t < h) sh[t] = add(sh[t], sh[t + h]);
    __syncthreads();
  }
  const T total = sh[0];
  __syncthreads();
  return total;
}

// ops/simplex.py project_simplex of y = w + dalpha * lr into x (which may be
// w), with s (L values of scratch) for y sorted descending
template <typename T>
__device__ void project_simplex(const T* w, const T* dalpha, T lr, T* s, T* x, int L) {
  for (int q = 0; q < L; ++q) {  // insertion sort of y, descending
    const T v = add(w[q], mul(dalpha[q], lr));
    int r = q - 1;
    while (r >= 0 && s[r] < v) {
      s[r + 1] = s[r];
      --r;
    }
    s[r + 1] = v;
  }
  T css = T(0), pick = T(0);
  for (int q = 0; q < L; ++q) {  // the first threshold at or above the next value
    css = add(css, s[q]);
    const T tmax = dvd(sub(css, T(1)), static_cast<T>(q + 1));
    if (q == L - 1 || tmax >= s[q + 1]) {
      pick = tmax;
      break;
    }
  }
  for (int q = 0; q < L; ++q) x[q] = clamp_min(sub(add(w[q], mul(dalpha[q], lr)), pick), T(0));
}

// ops/simplex.py softmax_natural_step of w into x (which may be w): alpha =
// exp(w) / sum exp(w), recomputed where it is needed rather than kept
template <typename T>
__device__ void softmax_natural_step(const T* w, const T* dalpha, T lr, T clip, T* x, int L) {
  T sum = T(0), dot = T(0);
  for (int q = 0; q < L; ++q) sum = add(sum, exp_(w[q]));
  for (int q = 0; q < L; ++q) dot = add(dot, mul(dalpha[q], dvd(exp_(w[q]), sum)));
  for (int q = 0; q < L; ++q) {
    const T e = dvd(exp_(w[q]), sum);
    x[q] = clamp(add(w[q], mul(mul(e, sub(dalpha[q], dot)), lr)), -clip, clip);
  }
}

template <typename T>
__global__ void __launch_bounds__(kTailThreads) sweep_tail_kernel(const TailArgs<T> A) {
  __shared__ T sh[kTailThreads];
  const int L = A.L, G = A.G;
  const int count = L * G;
  T* dalpha = A.aux + 3;
  const T energy = block_sum(sh, A.part2, count);
  for (int l = 0; l < L; ++l) {
    const T v = block_sum(sh, A.part2 + static_cast<size_t>(l) * G * 4 + 1, G);
    if (threadIdx.x == 0) dalpha[l] = v;
  }
  T dmu = block_sum(sh, A.part2 + 2, count), dsig = block_sum(sh, A.part2 + 3, count);
  if (A.part1 != nullptr) {  // red-black: the first pass's, then the second's
    dmu = add(block_sum(sh, A.part1 + 2, count), dmu);
    dsig = add(block_sum(sh, A.part1 + 3, count), dsig);
  }
  if (threadIdx.x != 0) return;
  const int it = *A.it;
  const T temp = *A.temp, step = *A.step;
  const bool act = (A.active == nullptr || *A.active) && (A.stop == nullptr || !*A.stop);
  // w: each component read before its own output is written (w_out may be w)
  if (act && L > 1 && it > A.alpha_start) {
    const T lr = mul(step, A.lr_scale);
    if (A.softmax_mode)
      softmax_natural_step(A.w, dalpha, lr, A.w_clip, A.w_out, L);
    else
      project_simplex(A.w, dalpha, lr, dalpha + L, A.w_out, L);
  } else if (A.w_out != A.w) {
    for (int q = 0; q < L; ++q) A.w_out[q] = A.w[q];
  }
  T tn = temp;
  if (A.anneal_every > 0 && it % A.anneal_every == 0)
    tn = clamp_min(mul(temp, A.drate), A.t_floor);
  *A.temp_out = act ? tn : temp;
  const int itn = act ? it + 1 : it;
  *A.it_out = itn;
  const T ptdmu = dvd(dmu, A.n_interior), ptdsig = dvd(dsig, A.n_interior);
  A.aux[0] = energy;
  A.aux[1] = ptdmu;
  A.aux[2] = ptdsig;
  if (A.n != nullptr && act) {  // the device loop's trace slot, stop rule and count
    const long long slot = *A.n < A.cap - 1 ? *A.n : A.cap - 1;
    A.bufs[slot] = energy;
    A.bufs[A.cap + slot] = ptdmu;
    A.bufs[2 * static_cast<size_t>(A.cap) + slot] = ptdsig;
    if (ptdmu < A.tor || itn > A.its) *A.stop_out = true;
    *A.n += 1;
  }
}

// ptrs: kTailPtrs pointers in TailArgs' order (part1, part2, w, T, step, it, active, stop,
// w_out, T_out, it_out, aux, n, stop_out, bufs); consts: kTailConsts doubles (lr_scale,
// drate, t_floor, n_interior, tor, w_clip).
template <typename T>
int sweep_tail(const void* ptrs, const void* consts, int L, int G, int alpha_start,
               int anneal_every, int its, int cap, int softmax_mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L < 1 || G < 1 || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* const* p = static_cast<const void* const*>(ptrs);
  const double* k = static_cast<const double*>(consts);
  TailArgs<T> a;
  a.part1 = static_cast<const T*>(p[0]);
  a.part2 = static_cast<const T*>(p[1]);
  a.w = static_cast<const T*>(p[2]);
  a.temp = static_cast<const T*>(p[3]);
  a.step = static_cast<const T*>(p[4]);
  a.it = static_cast<const int*>(p[5]);
  a.active = static_cast<const bool*>(p[6]);
  a.stop = static_cast<const bool*>(p[7]);
  a.w_out = static_cast<T*>(const_cast<void*>(p[8]));
  a.temp_out = static_cast<T*>(const_cast<void*>(p[9]));
  a.it_out = static_cast<int*>(const_cast<void*>(p[10]));
  a.aux = static_cast<T*>(const_cast<void*>(p[11]));
  a.n = static_cast<long long*>(const_cast<void*>(p[12]));
  a.stop_out = static_cast<bool*>(const_cast<void*>(p[13]));
  a.bufs = static_cast<T*>(const_cast<void*>(p[14]));
  if (a.part2 == nullptr || a.aux == nullptr ||
      (a.n != nullptr && (a.stop_out == nullptr || a.bufs == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.lr_scale = static_cast<T>(k[0]);
  a.drate = static_cast<T>(k[1]);
  a.t_floor = static_cast<T>(k[2]);
  a.n_interior = static_cast<T>(k[3]);
  a.tor = static_cast<T>(k[4]);
  a.w_clip = static_cast<T>(k[5]);
  a.L = L;
  a.G = G;
  a.alpha_start = alpha_start;
  a.anneal_every = anneal_every;
  a.its = its;
  a.cap = cap;
  a.softmax_mode = softmax_mode;
  sweep_tail_kernel<T><<<1, kTailThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define GQMAP_SITE_UPDATE(NAME, T)                                                           \
  extern "C" int NAME(const void* ptrs, const void* consts, int node_form, int edge_form,   \
                      int L, int M, int N, int colour, int device, void* stream) {          \
    return site_update<T>(ptrs, consts, node_form, edge_form, L, M, N, colour, device,      \
                          stream);                                                          \
  }

#define GQMAP_SWEEP_TAIL(NAME, T)                                                            \
  extern "C" int NAME(const void* ptrs, const void* consts, int L, int G, int alpha_start,  \
                      int anneal_every, int its, int cap, int softmax_mode, int device,     \
                      void* stream) {                                                       \
    return sweep_tail<T>(ptrs, consts, L, G, alpha_start, anneal_every, its, cap,           \
                         softmax_mode, device, stream);                                     \
  }

GQMAP_SITE_UPDATE(gqmap_site_update_f32, float)
GQMAP_SITE_UPDATE(gqmap_site_update_f64, double)
GQMAP_SWEEP_TAIL(gqmap_sweep_tail_f32, float)
GQMAP_SWEEP_TAIL(gqmap_sweep_tail_f64, double)
