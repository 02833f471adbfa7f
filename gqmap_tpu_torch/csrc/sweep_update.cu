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
// Two variants. v1, described here, is one thread a site and K9 a launch of
// its own; v2 (site_update_v2_kernel, the default, described at its code)
// stages 2-D tiles in shared memory, finalizes each raw edge once, runs K9's
// work in its last CTA and, on the device loop, writes the next sweep's inputs.
//
// K8 v1, "site update" (one launch a pass; grid (sites / 256, L), one thread a
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

// the node term's finalized gradients from its route's fields, field k read
// as f(k)
template <typename T, int NODE, typename F>
__device__ __forceinline__ Grads<T> node_grads_of(const F& f, T a, T o1, T o2, T p, T cn,
                                                  const Consts<T>& c) {
  if constexpr (NODE == kModes) {  // ops/cosine.py _finalize_mode_sums
    const T E0 = f(0), A1 = f(1), A2 = f(2), Aa = f(3), Ab = f(4), Ax = f(5);
    const T s1 = mul(o1, c.ku), s2 = mul(o2, c.kv);
    const T dEdo1 = mul(sub(mul(mul(s2, p), Ax), mul(s1, Aa)), c.hku);
    const T dEdo2 = mul(sub(mul(mul(s1, p), Ax), mul(s2, Ab)), c.hkv);
    const T dEdp = mul(mul(mul(s1, T(0.5)), s2), Ax);
    return closed(mul(E0, T(0.5)), mul(A1, c.mhku), mul(A2, c.hkv), dEdo1, dEdo2, dEdp, a, o1,
                  o2, p, cn, c);
  } else if constexpr (NODE == kRaw) {
    return finalize(f(0), f(1), f(2), f(3), f(4), f(5), a, o1, o2, p, cn, c);
  } else {  // ops/gq.py finalize_chain of (Ei, A1, A2, Ci, Cj, Di, Dj)
    const T Ci = f(3), Cj = f(4), Di = f(5), Dj = f(6);
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
    return closed(mul(f(0), c.inv_pi), mul(f(1), c.inv_pi), mul(f(2), c.inv_pi), dEdo1, dEdo2,
                  dEdp, a, o1, o2, p, cn, c);
  }
}

// the node term's finalized gradients at site i from its route's fields
template <typename T, int NODE>
__device__ __forceinline__ Grads<T> node_grads(const SiteArgs<T>& A, size_t i, T a, T o1, T o2,
                                               T p, T cn) {
  return node_grads_of<T, NODE>([&](int k) { return A.node[k][i]; }, a, o1, o2, p, cn, A.c);
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

// K9's scalar tail on one thread, from the sums: the alpha step, the anneal,
// the counter and the predicate, SweepAux, and the device loop's trace slot,
// stop flag and count. w: the L weights (A.w, or a copy), x: where the new ones
// go (A.w_out, which may be w, or a copy), scratch: L values; it, temp, step,
// act and n (the loop's count) as read before. Returns the new it.
template <typename T>
__device__ int tail_scalar(const TailArgs<T>& A, T energy, T dmu, T dsig, const T* dalpha,
                           const T* w, T* x, T* scratch, int it, T temp, T step, bool act,
                           long long n) {
  const int L = A.L;
  // w: each component read before its own output is written (x may be w)
  if (act && L > 1 && it > A.alpha_start) {
    const T lr = mul(step, A.lr_scale);
    if (A.softmax_mode)
      softmax_natural_step(w, dalpha, lr, A.w_clip, x, L);
    else
      project_simplex(w, dalpha, lr, scratch, x, L);
  } else if (x != w) {
    for (int q = 0; q < L; ++q) x[q] = w[q];
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
    const long long slot = n < A.cap - 1 ? n : A.cap - 1;
    A.bufs[slot] = energy;
    A.bufs[A.cap + slot] = ptdmu;
    A.bufs[2 * static_cast<size_t>(A.cap) + slot] = ptdsig;
    if (ptdmu < A.tor || itn > A.its) *A.stop_out = true;
    *A.n = n + 1;
  }
  return itn;
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
  if (threadIdx.x == 0) {
    const bool act = (A.active == nullptr || *A.active) && (A.stop == nullptr || !*A.stop);
    tail_scalar(A, energy, dmu, dsig, dalpha, A.w, A.w_out, dalpha + L, *A.it, *A.temp,
                *A.step, act, A.n == nullptr ? 0 : *A.n);
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

// ---- K8 v2 and K9 v2 -------------------------------------------------------------------
//
// K8 v2 takes 2-D tiles of one component's sites, kTW columns by kTH rows, one
// thread a site, in a persistent loop over the lattice (grid: the CTAs that fit
// on the card at once, or fewer). Each tile's fields (the state, the node
// route's and the edge route's planes) and its halo (the row above and the
// column to the left: the end-2 inputs of the edges that come back into the
// tile; for raw edges also sigma one row below and one column right) are staged
// into shared memory by cp.async, double-buffered: tile t + 1 loads while tile t
// computes. Each raw edge is finalized once, by the site that owns it, and its
// end-2 terms (du2, do2) go through shared memory to the site one row down or
// one column right; only the halo's kTW + kTH edges a channel are evaluated for
// their end-2 terms alone (finalize_end2: the same operations as finalize's
// du2 and do2, so the state is v1's bit for bit). Each tile writes one partial
// of the energy, dalpha, sum |dmuu| and sum |dsigmau| (a shuffle tree over a
// warp's row, then a halving tree over the 8 warps).
//
// K9 v2 is K8 v2's last CTA: each CTA, done with its tiles, takes a ticket
// from a counter in global memory after a __threadfence(); the CTA that draws
// the last one sums every partial (a thread's strided running sums from 0 over
// kThreads threads, then a halving tree; all of the 3 + L sums in one pass),
// runs K9's scalar tail (tail_scalar) and resets the ticket, so a CUDA graph
// replays it. No atomic touches a sum: only the choice of the CTA varies.
//
// The carry (the segment runner's device loop): K8 v2 also writes, from each
// site's new state, K1's phase and scale stack (5, L, M, N) and K3's
// neighbour stacks u2e and o2e (each site's mu and sigma into its up and left
// neighbours' slots), and the tail writes the next sweep's step and alpha =
// softmax(w), each as PyTorch's CUDA kernels round the plain expressions:
// tensor / scalar is a product by the scalar's reciprocal in the tensor's
// type, and e.sum() over L values takes the order of PyTorch's reduction
// (torch_sum below). Without the carry each is null.

constexpr int kTW = 32, kTH = kThreads / kTW;  // K8 v2's tile: a warp a row
constexpr int kWarps = kThreads / 32;
constexpr int kHalo = kTW + kTH;                // halo sites: the row above, the column left
constexpr int kMaxPlanes = 9 + 7 + 24;          // state, node fields, edge fields
constexpr int kStageHalo = 12 * kHalo;          // 10 end-2 inputs and 2 sigmas a halo site
constexpr int kMaxCarryL = 64;                  // alpha's carry: up to where torch_sum is held

template <typename T>
struct UpdateV2Args {
  SiteArgs<T> s;                  // K8's; s.out may be the state's own buffer (grads form)
  const T* plane[kMaxPlanes];     // the staged planes at a site: the state's 9, the node
                                  // route's fields, then edge field f, plane q at 4 f + q
  int nplanes, node_off, edge_off;
  const T* part_prev;             // red-black pass 1's partials, or null
  unsigned* ticket;               // null: no tail in this launch
  TailArgs<T> t;                  // the tail's (part1, part2 and G unused)
  T *stack, *u2e, *o2e, *step_next, *alpha_next;  // the carry, each null when not carried
  T lo_u, lo_v, inv_tau, step0;
  int step_const;
  int tiles_n, tiles_l, ntiles;   // tiles across a row, a component, in all
  int vec16;                      // every plane's rows start 16-byte aligned: 16-byte copies
};
constexpr int kV2Ptrs = 43;
constexpr int kV2Consts = kConsts + kTailConsts + 4;
constexpr int kV2Ints = 13;

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}
template <typename T>
__device__ __forceinline__ void cp_async16(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct TileAt {
  int l, tl, m0, n0, vr, vc;  // component, tile in it, first row and column, valid rows, cols
};

template <typename T>
__device__ __forceinline__ TileAt tile_at(const UpdateV2Args<T>& A, int tile) {
  TileAt t;
  t.l = tile / A.tiles_l;
  t.tl = tile - t.l * A.tiles_l;
  t.m0 = (t.tl / A.tiles_n) * kTH;
  t.n0 = (t.tl % A.tiles_n) * kTW;
  t.vr = min(kTH, A.s.M - t.m0);
  t.vc = min(kTW, A.s.N - t.n0);
  return t;
}

// tile's planes into B[k * kThreads + site], its halo into H = B + nplanes * kThreads:
// H[v * kHalo + h], h < kTW the row above (or, for sigma, below), h >= kTW the
// column left (right); v < 10 the end-2 inputs, channel ch at 5 ch (raw: Z1, Z2,
// Sa, Sm, rho) or 2 ch (grads: du2, do2); v = 10, 11 sigma u, v
template <typename T, int EDGE>
__device__ __forceinline__ void stage_tile(const UpdateV2Args<T>& A, T* B, int tile, int tid) {
  const int M = A.s.M, N = A.s.N;
  const TileAt t = tile_at(A, tile);
  const size_t base = static_cast<size_t>(t.l) * M * N;
  const int r = tid / kTW, c = tid - r * kTW;
  if (A.vec16) {  // 16-byte chunks of a row: plane, row and chunk from one index
    constexpr int V = 16 / sizeof(T), C = kTW / V;
    for (int q = tid; q < A.nplanes * kTH * C; q += kThreads) {
      const int k = q / (kTH * C), rr = (q / C) % kTH, cc = (q % C) * V;
      if (rr >= t.vr || cc >= t.vc) continue;
      T* dst = B + k * kThreads + rr * kTW + cc;
      const T* src = A.plane[k] + base + static_cast<size_t>(t.m0 + rr) * N + t.n0 + cc;
      if (cc + V <= t.vc) {
        cp_async16(dst, src);
      } else {
        for (int e = 0; e < t.vc - cc; ++e) cp_async(dst + e, src + e);
      }
    }
  } else if (r < t.vr && c < t.vc) {
    const size_t i = base + static_cast<size_t>(t.m0 + r) * N + t.n0 + c;
    for (int k = 0; k < A.nplanes; ++k) cp_async(B + k * kThreads + tid, A.plane[k] + i);
  }
  T* H = B + A.nplanes * kThreads;
  for (int h = tid; h < kHalo; h += kThreads) {  // the row above (dir 0), the column left
    const bool up = h < kTW;
    if (up ? h < t.vc : h - kTW < t.vr) {
      const int hm = up ? (t.m0 == 0 ? M - 1 : t.m0 - 1) : t.m0 + h - kTW;
      const int hn = up ? t.n0 + h : (t.n0 == 0 ? N - 1 : t.n0 - 1);
      const size_t i = base + static_cast<size_t>(hm) * N + hn;
      const int d = up ? 0 : 1;
      for (int ch = 0; ch < 2; ++ch) {
        const int q = 2 * d + ch;
        if constexpr (EDGE == kRaw) {
          for (int f = 1; f <= 4; ++f)
            cp_async(H + (5 * ch + f - 1) * kHalo + h, A.plane[A.edge_off + 4 * f + q] + i);
          cp_async(H + (5 * ch + 4) * kHalo + h, A.plane[5 + q] + i);
        } else {
          cp_async(H + (2 * ch) * kHalo + h, A.plane[A.edge_off + 4 * 2 + q] + i);
          cp_async(H + (2 * ch + 1) * kHalo + h, A.plane[A.edge_off + 4 * 4 + q] + i);
        }
      }
    }
  }
  if constexpr (EDGE == kRaw) {  // sigma one row below and one column right
    for (int h = (tid + kThreads / 2) % kThreads; h < kHalo; h += kThreads) {
      const bool down = h < kTW;
      if (down ? h < t.vc : h - kTW < t.vr) {
        const int hm = down ? (t.m0 + t.vr) % M : t.m0 + h - kTW;
        const int hn = down ? t.n0 + h : (t.n0 + t.vc) % N;
        const size_t i = base + static_cast<size_t>(hm) * N + hn;
        cp_async(H + 10 * kHalo + h, A.plane[2] + i);
        cp_async(H + 11 * kHalo + h, A.plane[3] + i);
      }
    }
  }
}

// one tile from its staged buffer B: X (8 planes of kThreads) carries each
// site's own edges' end-2 terms, HX (4 kHalo) the halo's, Wr (4 x kWarps) the
// warps' sums (tile_partial turns them into the tile's partials)
template <typename T, int NODE, int EDGE>
__device__ __forceinline__ void tile_update(const UpdateV2Args<T>& A, const T* B, T* X, T* HX,
                                            T* Wr, int tile, int tid, T cn_node, T cn_edge,
                                            T step, bool live) {
  const Consts<T>& c = A.s.c;
  const int L = A.s.L, M = A.s.M, N = A.s.N;
  const size_t S = static_cast<size_t>(M) * N, plane = L * S;
  const TileAt t = tile_at(A, tile);
  const int r = tid / kTW, cc = tid - r * kTW;
  const int m = t.m0 + r, n = t.n0 + cc;
  const bool valid = r < t.vr && cc < t.vc;
  const size_t i = static_cast<size_t>(t.l) * S + static_cast<size_t>(m) * N + n;
  const T* H = B + A.nplanes * kThreads;
  const T a = A.s.alpha[t.l];
  const int eo = A.edge_off;
  auto at = [&](int k) { return B[k * kThreads + tid]; };

  bool interior = false, mask = false;
  T p1[4], e_sum = T(0), da_sum = T(0), dpn = T(0);
  if (valid) {
    const T su = at(2), sv = at(3), pn = at(4);
    interior = A.s.interior[static_cast<size_t>(m) * N + n];
    mask = interior && live && (A.s.colour < 0 || ((m + n) & 1) == A.s.colour);
    const Grads<T> gn = node_grads_of<T, NODE>([&](int k) { return at(A.node_off + k); }, a, su,
                                               sv, pn, cn_node, c);
    p1[0] = gn.du1;
    p1[1] = gn.du2;
    p1[2] = gn.do1;
    p1[3] = gn.do2;
    e_sum = gn.E;
    da_sum = gn.da;
    dpn = gn.dp;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const int q = 2 * d + ch;
        const T rq = at(5 + q);
        T da, du1, do1, dp, E;
        if constexpr (EDGE == kGrads) {  // K2's finalized gradients
          da = at(eo + q);
          du1 = at(eo + 4 + q);
          do1 = at(eo + 12 + q);
          dp = at(eo + 20 + q);
          E = mul(a, da);
        } else {  // the edge's raw sums, finalized once; its end-2 terms into X
          const T sg = ch == 0 ? su : sv;
          // endpoint 2's sigma: the site one row down or one column right
          const T o2 = d == 0 ? (r + 1 < t.vr ? B[(2 + ch) * kThreads + tid + kTW]
                                              : H[(10 + ch) * kHalo + cc])
                              : (cc + 1 < t.vc ? B[(2 + ch) * kThreads + tid + 1]
                                               : H[(10 + ch) * kHalo + kTW + r]);
          const Grads<T> g = finalize(at(eo + q), at(eo + 4 + q), at(eo + 8 + q),
                                      at(eo + 12 + q), at(eo + 16 + q), at(eo + 20 + q), a, sg,
                                      o2, rq, cn_edge, c);
          da = g.da;
          du1 = g.du1;
          do1 = g.do1;
          dp = g.dp;
          E = g.E;
          X[(2 * q) * kThreads + tid] = g.du2;
          X[(2 * q + 1) * kThreads + tid] = g.do2;
        }
        p1[ch] = add(p1[ch], du1);
        p1[2 + ch] = add(p1[2 + ch], do1);
        e_sum = add(e_sum, E);
        da_sum = add(da_sum, da);
        A.s.out[(5 + q) * plane + i] = mask ? clamp(add(rq, mul(dp, step)), c.rmin, c.rmax) : rq;
      }
    }
  }
  if constexpr (EDGE == kRaw) {  // the halo's edges, their end-2 terms alone
    for (int e = tid; e < 2 * kHalo; e += kThreads) {
      const int ch = e < 2 * kTW ? e / kTW : (e - 2 * kTW) / kTH;
      const int h = e < 2 * kTW ? e - ch * kTW : kTW + (e - 2 * kTW) - ch * kTH;
      const bool up = h < kTW;
      if (up ? h < t.vc : h - kTW < t.vr) {
        const T o2 = B[(2 + ch) * kThreads + (up ? h : (h - kTW) * kTW)];  // the tile's own site
        const T* hv = H + 5 * ch * kHalo + h;
        T du2, do2;
        finalize_end2(hv[0], hv[kHalo], hv[2 * kHalo], hv[3 * kHalo], a, o2, hv[4 * kHalo],
                      cn_edge, c, du2, do2);
        HX[(2 * ch) * kHalo + h] = du2;
        HX[(2 * ch + 1) * kHalo + h] = do2;
      }
    }
    __syncthreads();  // X and HX, which K2's gradients do not need: their end-2 terms are staged
  }

  T v_energy = T(0), v_da = T(0), v_dmu = T(0), v_dsig = T(0);
  if (valid) {
    // the end-2 terms of the edges one row up (dir 0) and one column left (dir 1)
    T up[2][2], left[2][2];  // [mu | sigma][chan]
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if constexpr (EDGE == kGrads) {
          const int f = k == 0 ? 2 : 4;  // du2, do2
          up[k][ch] = r > 0 ? B[(eo + 4 * f + ch) * kThreads + tid - kTW]
                            : H[(2 * ch + k) * kHalo + cc];
          left[k][ch] = cc > 0 ? B[(eo + 4 * f + 2 + ch) * kThreads + tid - 1]
                               : H[(2 * ch + k) * kHalo + kTW + r];
        } else {
          up[k][ch] = r > 0 ? X[(2 * ch + k) * kThreads + tid - kTW] : HX[(2 * ch + k) * kHalo + cc];
          left[k][ch] = cc > 0 ? X[(2 * (2 + ch) + k) * kThreads + tid - 1]
                               : HX[(2 * ch + k) * kHalo + kTW + r];
        }
      }
    }
    // assemble (models/gqmap.py): dn + d1[0, chan] + d1[1, chan] + up + left
    const T dmuu = add(add(p1[0], up[0][0]), left[0][0]);
    const T dmuv = add(add(p1[1], up[0][1]), left[0][1]);
    const T dsu = add(add(p1[2], up[1][0]), left[1][0]);
    const T dsv = add(add(p1[3], up[1][1]), left[1][1]);
    const T sstep = mul(step, c.sscale);
    const T muu = at(0), muv = at(1), su = at(2), sv = at(3), pn = at(4);
    const T nmu[2] = {mask ? clamp(add(muu, mul(dmuu, step)), c.minu, c.maxu) : muu,
                      mask ? clamp(add(muv, mul(dmuv, step)), c.minv, c.maxv) : muv};
    const T nsg[2] = {mask ? clamp(add(su, mul(dsu, sstep)), c.smin, c.smax) : su,
                      mask ? clamp(add(sv, mul(dsv, sstep)), c.smin, c.smax) : sv};
    const T npn = mask ? clamp(add(pn, mul(dpn, step)), c.rmin, c.rmax) : pn;
    T* out = A.s.out;
    out[0 * plane + i] = nmu[0];
    out[1 * plane + i] = nmu[1];
    out[2 * plane + i] = nsg[0];
    out[3 * plane + i] = nsg[1];
    out[4 * plane + i] = npn;
    if (A.stack != nullptr) {  // K1's phases and scales: ku (mu - lo), ku sigma, ..., p
      A.stack[0 * plane + i] = mul(sub(nmu[0], A.lo_u), c.ku);
      A.stack[1 * plane + i] = mul(sub(nmu[1], A.lo_v), c.kv);
      A.stack[2 * plane + i] = mul(nsg[0], c.ku);
      A.stack[3 * plane + i] = mul(nsg[1], c.kv);
      A.stack[4 * plane + i] = npn;
    }
    if (A.u2e != nullptr) {  // endpoint 2 of the edges of the sites one row up, one column left
      const size_t li = static_cast<size_t>(t.l) * S;
      const size_t ju = li + static_cast<size_t>(m == 0 ? M - 1 : m - 1) * N + n;
      const size_t jl = li + static_cast<size_t>(m) * N + (n == 0 ? N - 1 : n - 1);
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        A.u2e[ch * plane + ju] = nmu[ch];
        A.o2e[ch * plane + ju] = nsg[ch];
        A.u2e[(2 + ch) * plane + jl] = nmu[ch];
        A.o2e[(2 + ch) * plane + jl] = nsg[ch];
      }
    }
    if (interior) {
      v_energy = e_sum;
      v_da = da_sum;
    }
    if (mask) {
      v_dmu = fabs(dmuu);
      v_dsig = fabs(dsu);
    }
  }
  // the tile's partials: a halving tree over each warp's 32 sites (consecutive in
  // the tile's row-major order), then over the kWarps warps
  T v[4] = {v_energy, v_da, v_dmu, v_dsig};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = add(v[k], __shfl_down_sync(0xffffffffu, v[k], o));
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) Wr[k * kWarps + (tid >> 5)] = v[k];
  }
}

// thread k < 4 of the CTA: the tile's partial k from its warps' sums Wr (a
// halving tree over the warps), once a barrier has made them visible
template <typename T>
__device__ __forceinline__ void tile_partial(const UpdateV2Args<T>& A, const T* Wr, int tile,
                                             int k) {
  T w[kWarps];
#pragma unroll
  for (int q = 0; q < kWarps; ++q) w[q] = Wr[k * kWarps + q];
#pragma unroll
  for (int h = kWarps / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int q = 0; q < h; ++q) w[q] = add(w[q], w[q + h]);
  }
  A.s.part[static_cast<size_t>(tile) * 4 + k] = w[0];
}

// the sum of x[0..n) in the order of PyTorch's CUDA reduction of a contiguous
// tensor of n <= kMaxCarryL values (e.sum() in ops/simplex.softmax): n rounded
// down to a power of two, bw, threads, thread j adding x[j] and x[j + bw];
// then a halving tree over the bw threads (block_x_reduce: shared memory down
// to a warp, then shuffles with offsets decreasing to 1); acc: bw values of
// scratch
template <typename T>
__device__ T torch_sum(const T* x, int n, T* acc) {
  int bw = 1;
  while (2 * bw <= n) bw *= 2;
  for (int j = 0; j < bw; ++j) acc[j] = j + bw < n ? add(x[j], x[j + bw]) : x[j];
  for (int o = bw / 2; o > 0; o >>= 1)
    for (int j = 0; j < o; ++j) acc[j] = add(acc[j], acc[j + o]);
  return acc[0];
}

// a halving tree over kThreads values of each of n arrays sh[k * kThreads + j]
// (h = 128, 64, 32 in shared memory, every (array, j) pair of a level spread
// over the CTA; then 16 .. 1 by shuffles, warp w taking arrays w, w + kWarps,
// ..., the same order); thread 0 finds the totals in tot after the last barrier
template <typename T>
__device__ void tail_tree(T* sh, int n, T* tot) {
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int h = kThreads / 2; h >= 32; h >>= 1) {
    __syncthreads();
    for (int e = tid; e < h * n; e += kThreads) {
      const int k = e / h, j = e - k * h;
      sh[k * kThreads + j] = add(sh[k * kThreads + j], sh[k * kThreads + j + h]);
    }
  }
  __syncthreads();
  for (int k = tid >> 5; k < n; k += kWarps) {
    T v = sh[k * kThreads + (tid & 31)];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, o));
    if ((tid & 31) == 0) tot[k] = v;
  }
  __syncthreads();
}

// the last CTA: every partial summed in a fixed order, all of the 3 + L sums in
// one pass (thread j's running sums over j, j + kThreads, ..., its loads issued
// kBatch strides at a time; dalpha[l] adds the partials of component l among
// them), then tail_tree; then K9's scalar tail and the carry's step and alpha.
// sh holds (5 + 32) x kThreads values; spare, nspare values, the weights
constexpr int kBatch = 8;

template <typename T>
__device__ void fused_tail(const UpdateV2Args<T>& A, T* sh, T* spare, int nspare, T temp,
                           T step, bool act) {
  __shared__ T tot[5 + 32];
  const int tid = threadIdx.x;
  const int L = A.s.L, G = A.tiles_l, count = L * G;
  const T* part = A.s.part;
  const T* prev = A.part_prev;
  // the weights, dalpha, the new weights and scratch in shared memory where they fit
  const bool local = 4 * L <= nspare;
  T* w = local ? spare : const_cast<T*>(A.t.w);
  T* dalpha = local ? spare + L : A.t.aux + 3;
  T* x = local ? spare + 2 * L : A.t.w_out;
  T* scratch = local ? spare + 3 * L : A.t.aux + 3 + L;
  if (local)
    for (int q = tid; q < L; q += kThreads) w[q] = A.t.w[q];
  int it = 0;
  long long n = 0;
  if (tid == 0) {  // in flight while the sums load
    it = *A.t.it;
    n = A.t.n == nullptr ? 0 : *A.t.n;
  }
  T energy = T(0), dmu = T(0), dsig = T(0), dmu1 = T(0), dsig1 = T(0);
  for (int l0 = 0; l0 < L; l0 += 32) {  // the components' dalpha, 32 at a time
    const int nl = min(32, L - l0);
    const bool first = l0 == 0;
    T v[5] = {T(0), T(0), T(0), T(0), T(0)};
    for (int q = 0; q < nl; ++q) sh[(5 + q) * kThreads + tid] = T(0);
    for (int j0 = tid; j0 < count; j0 += kBatch * kThreads) {
      T xv[kBatch][6];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {  // loads first, in flight together
        const int j = j0 + u * kThreads;
        const bool in = j < count;
        const size_t o = static_cast<size_t>(in ? j : 0) * 4;
        xv[u][0] = in && first ? __ldcg(part + o) : T(0);
        xv[u][1] = in ? __ldcg(part + o + 1) : T(0);
        xv[u][2] = in && first ? __ldcg(part + o + 2) : T(0);
        xv[u][3] = in && first ? __ldcg(part + o + 3) : T(0);
        xv[u][4] = in && first && prev != nullptr ? __ldcg(prev + o + 2) : T(0);
        xv[u][5] = in && first && prev != nullptr ? __ldcg(prev + o + 3) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {  // a zero past the end leaves a sum as it is
        const int j = j0 + u * kThreads;
        v[0] = add(v[0], xv[u][0]);
        v[1] = add(v[1], xv[u][2]);
        v[2] = add(v[2], xv[u][3]);
        v[3] = add(v[3], xv[u][4]);
        v[4] = add(v[4], xv[u][5]);
        const int l = j / G - l0;
        if (j < count && l >= 0 && l < nl)
          sh[(5 + l) * kThreads + tid] = add(sh[(5 + l) * kThreads + tid], xv[u][1]);
      }
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) sh[k * kThreads + tid] = v[k];
    tail_tree(sh, 5 + nl, tot);
    if (tid == 0) {
      if (first) {
        energy = tot[0];
        dmu = tot[1];
        dsig = tot[2];
        dmu1 = tot[3];
        dsig1 = tot[4];
      }
      for (int q = 0; q < nl; ++q) dalpha[l0 + q] = tot[5 + q];
    }
  }
  if (tid != 0) return;
  if (prev != nullptr) {  // red-black: the first pass's, then the second's, as K9 v1
    dmu = add(dmu1, dmu);
    dsig = add(dsig1, dsig);
  }
  const int itn = tail_scalar(A.t, energy, dmu, dsig, dalpha, w, x, scratch, it, temp, step,
                              act, n);
  if (local) {  // the outputs that live in global memory
    for (int q = 0; q < L; ++q) {
      A.t.aux[3 + q] = dalpha[q];
      A.t.w_out[q] = x[q];
    }
  }
  if (A.step_next != nullptr) {  // step0 / (1 + it / step_tau) of the new it
    const T itf = static_cast<T>(itn);
    *A.step_next =
        A.step_const ? A.step0 : mul(dvd(T(1), add(mul(itf, A.inv_tau), T(1))), A.step0);
  }
  if (A.alpha_next != nullptr) {  // softmax(w) of the new w: e / e.sum()
    T* e = scratch;
    for (int q = 0; q < L; ++q) e[q] = exp_(x[q]);
    const T s = torch_sum(e, L, sh);
    for (int q = 0; q < L; ++q) A.alpha_next[q] = dvd(e[q], s);
  }
  *A.ticket = 0u;  // for the next launch (a graph replays this one)
}

__host__ __device__ constexpr int v2_stage(int nplanes) {
  return nplanes * kThreads + kStageHalo;
}

template <typename T>
__host__ __device__ constexpr size_t v2_smem(int nplanes) {
  return sizeof(T) * (2 * v2_stage(nplanes) + 8 * kThreads + 4 * kHalo + 8 * kWarps);
}

template <typename T, int NODE, int EDGE>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
    site_update_v2_kernel(const UpdateV2Args<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int stage = v2_stage(A.nplanes);
  T* X = sm + 2 * stage;
  T* HX = X + 8 * kThreads;
  T* Wr = HX + 4 * kHalo;
  const int tid = threadIdx.x;
  const T temp = *A.s.temp, step = *A.s.step;
  const T cn_node = mul(temp, A.s.c.es_node), cn_edge = mul(temp, A.s.c.es_edge);
  const bool live = (A.s.active == nullptr || *A.s.active) && (A.s.stop == nullptr || !*A.s.stop);
  int tile = blockIdx.x, k = 0;
  if (tile < A.ntiles) stage_tile<T, EDGE>(A, sm, tile, tid);
  cp_async_commit();
  for (; tile < A.ntiles; ++k, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < A.ntiles) stage_tile<T, EDGE>(A, sm + ((k + 1) & 1) * stage, next, tid);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (k > 0 && tid < 4)  // the last tile's partials (its warps' sums, double-buffered)
      tile_partial(A, Wr + ((k - 1) & 1) * 4 * kWarps, tile - gridDim.x, tid);
    tile_update<T, NODE, EDGE>(A, sm + (k & 1) * stage, X, HX, Wr + (k & 1) * 4 * kWarps, tile,
                               tid, cn_node, cn_edge, step, live);
    __syncthreads();
  }
  if (k > 0 && tid < 4) tile_partial(A, Wr + ((k - 1) & 1) * 4 * kWarps, tile - gridDim.x, tid);
  if (A.ticket == nullptr) return;
  if (tid < 4) __threadfence();  // this CTA's partials, before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(A.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  fused_tail(A, sm, sm + stage, stage, temp, step, live);
}

template <typename T, int NODE, int EDGE>
cudaError_t launch_v2(const UpdateV2Args<T>& a, int max_ctas, cudaStream_t stream) {
  auto kern = site_update_v2_kernel<T, NODE, EDGE>;
  const size_t smem = v2_smem<T>(a.nplanes);
  static int sms = 0, per_sm = 0;  // per instance: one card type a process
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(v2_smem<T>(kMaxPlanes)));
    if (err != cudaSuccess) return err;
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads, v2_smem<T>(kMaxPlanes));
    if (err != cudaSuccess) return err;
    per_sm = n > 0 ? n : 1;
  }
  int grid = per_sm * sms;
  if (max_ctas > 0 && max_ctas < grid) grid = max_ctas;
  if (a.ntiles < grid) grid = a.ntiles;
  site_update_v2_kernel<T, NODE, EDGE><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ptrs: kV2Ptrs pointers: K8's kSitePtrs (SiteArgs' order; out may be the state's
// buffer for the grads edge form), then part_prev, ticket (null: no tail), w, it,
// w_out, T_out, it_out, aux, n, stop_out, bufs (TailArgs'), stack, u2e, o2e,
// step_next, alpha_next (the carry); consts: kV2Consts doubles: Consts', the tail's
// (lr_scale, drate, t_floor, n_interior, tor, w_clip), lo_u, lo_v, inv_tau, step0;
// ints: kV2Ints: node_form, edge_form, L, M, N, colour, alpha_start, anneal_every, its,
// cap, softmax_mode, step_const, max_ctas (0: as many as fit at once).
template <typename T>
int site_update_v2(const void* ptrs, const void* consts, const void* ints, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* const* p = static_cast<const void* const*>(ptrs);
  const double* k = static_cast<const double*>(consts);
  const int* v = static_cast<const int*>(ints);
  const int node_form = v[0], edge_form = v[1], L = v[2], M = v[3], N = v[4], colour = v[5];
  if (L < 1 || M < 1 || N < 1 || static_cast<long long>(M) * N > (1LL << 30) ||
      node_form < kModes || node_form > kChain || edge_form < kGrads || edge_form > kRaw ||
      colour < -1 || colour > 1 || v[9] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  UpdateV2Args<T> a;
  SiteArgs<T>& s = a.s;
  s.muu = static_cast<const T*>(p[0]);
  s.muv = static_cast<const T*>(p[1]);
  s.su = static_cast<const T*>(p[2]);
  s.sv = static_cast<const T*>(p[3]);
  s.pn = static_cast<const T*>(p[4]);
  s.rou = static_cast<const T*>(p[5]);
  s.out = static_cast<T*>(const_cast<void*>(p[6]));
  s.alpha = static_cast<const T*>(p[7]);
  s.temp = static_cast<const T*>(p[8]);
  s.step = static_cast<const T*>(p[9]);
  s.interior = static_cast<const bool*>(p[10]);
  s.active = static_cast<const bool*>(p[11]);
  s.stop = static_cast<const bool*>(p[12]);
  for (int q = 0; q < 7; ++q) s.node[q] = static_cast<const T*>(p[13 + q]);
  for (int q = 0; q < 6; ++q) s.edge[q] = static_cast<const T*>(p[20 + q]);
  s.part = static_cast<T*>(const_cast<void*>(p[26]));
  T* cs = &s.c.ku;
  for (int q = 0; q < kConsts; ++q) cs[q] = static_cast<T>(k[q]);
  s.L = L;
  s.M = M;
  s.N = N;
  s.colour = colour;
  const size_t plane = static_cast<size_t>(L) * M * N;
  const int nnode = node_form == kChain ? 7 : 6;
  a.nplanes = 9 + nnode + 24;
  a.node_off = 9;
  a.edge_off = 9 + nnode;
  const T* state[5] = {s.muu, s.muv, s.su, s.sv, s.pn};
  for (int q = 0; q < 5; ++q) a.plane[q] = state[q];
  for (int q = 0; q < 4; ++q) a.plane[5 + q] = s.rou + q * plane;
  for (int q = 0; q < nnode; ++q) a.plane[9 + q] = s.node[q];
  for (int f = 0; f < 6; ++f)
    for (int q = 0; q < 4; ++q) a.plane[a.edge_off + 4 * f + q] = s.edge[f] + q * plane;
  for (int q = a.nplanes; q < kMaxPlanes; ++q) a.plane[q] = nullptr;
  a.part_prev = static_cast<const T*>(p[27]);
  a.ticket = static_cast<unsigned*>(const_cast<void*>(p[28]));
  TailArgs<T>& t = a.t;
  t.part1 = t.part2 = nullptr;
  t.w = static_cast<const T*>(p[29]);
  t.temp = s.temp;
  t.step = s.step;
  t.it = static_cast<const int*>(p[30]);
  t.active = s.active;
  t.stop = s.stop;
  t.w_out = static_cast<T*>(const_cast<void*>(p[31]));
  t.temp_out = static_cast<T*>(const_cast<void*>(p[32]));
  t.it_out = static_cast<int*>(const_cast<void*>(p[33]));
  t.aux = static_cast<T*>(const_cast<void*>(p[34]));
  t.n = static_cast<long long*>(const_cast<void*>(p[35]));
  t.stop_out = static_cast<bool*>(const_cast<void*>(p[36]));
  t.bufs = static_cast<T*>(const_cast<void*>(p[37]));
  a.stack = static_cast<T*>(const_cast<void*>(p[38]));
  a.u2e = static_cast<T*>(const_cast<void*>(p[39]));
  a.o2e = static_cast<T*>(const_cast<void*>(p[40]));
  a.step_next = static_cast<T*>(const_cast<void*>(p[41]));
  a.alpha_next = static_cast<T*>(const_cast<void*>(p[42]));
  t.lr_scale = static_cast<T>(k[kConsts + 0]);
  t.drate = static_cast<T>(k[kConsts + 1]);
  t.t_floor = static_cast<T>(k[kConsts + 2]);
  t.n_interior = static_cast<T>(k[kConsts + 3]);
  t.tor = static_cast<T>(k[kConsts + 4]);
  t.w_clip = static_cast<T>(k[kConsts + 5]);
  a.lo_u = static_cast<T>(k[kConsts + 6]);
  a.lo_v = static_cast<T>(k[kConsts + 7]);
  a.inv_tau = static_cast<T>(k[kConsts + 8]);
  a.step0 = static_cast<T>(k[kConsts + 9]);
  t.L = L;
  t.G = 0;
  t.alpha_start = v[6];
  t.anneal_every = v[7];
  t.its = v[8];
  t.cap = v[9];
  t.softmax_mode = v[10];
  a.step_const = v[11];
  a.tiles_n = (N + kTW - 1) / kTW;
  a.tiles_l = a.tiles_n * ((M + kTH - 1) / kTH);
  if (static_cast<long long>(a.tiles_l) * L > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  a.ntiles = a.tiles_l * L;
  a.vec16 = N % (16 / static_cast<int>(sizeof(T))) == 0;
  for (int q = 0; q < a.nplanes; ++q)
    a.vec16 = a.vec16 && reinterpret_cast<uintptr_t>(a.plane[q]) % 16 == 0;
  if ((a.u2e == nullptr) != (a.o2e == nullptr) ||
      (a.ticket != nullptr &&
       (t.w == nullptr || t.it == nullptr || t.w_out == nullptr || t.temp_out == nullptr ||
        t.it_out == nullptr || t.aux == nullptr ||
        (t.n != nullptr && (t.stop_out == nullptr || t.bufs == nullptr)))) ||
      ((a.step_next != nullptr || a.alpha_next != nullptr) && a.ticket == nullptr) ||
      (a.alpha_next != nullptr && (!t.softmax_mode || L > kMaxCarryL)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int max_ctas = v[12];
  switch (2 * node_form + edge_form) {
    case 2 * kModes + kGrads: return static_cast<int>(launch_v2<T, kModes, kGrads>(a, max_ctas, st));
    case 2 * kModes + kRaw: return static_cast<int>(launch_v2<T, kModes, kRaw>(a, max_ctas, st));
    case 2 * kRaw + kGrads: return static_cast<int>(launch_v2<T, kRaw, kGrads>(a, max_ctas, st));
    case 2 * kRaw + kRaw: return static_cast<int>(launch_v2<T, kRaw, kRaw>(a, max_ctas, st));
    case 2 * kChain + kGrads: return static_cast<int>(launch_v2<T, kChain, kGrads>(a, max_ctas, st));
    default: return static_cast<int>(launch_v2<T, kChain, kRaw>(a, max_ctas, st));
  }
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

#define GQMAP_SITE_UPDATE_V2(NAME, T)                                                        \
  extern "C" int NAME(const void* ptrs, const void* consts, const void* ints, int device,   \
                      void* stream) {                                                       \
    return site_update_v2<T>(ptrs, consts, ints, device, stream);                           \
  }

GQMAP_SITE_UPDATE_V2(gqmap_site_update_v2_f32, float)
GQMAP_SITE_UPDATE_V2(gqmap_site_update_v2_f64, double)
