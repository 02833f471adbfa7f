// Two ceilings of kernels/roofline.measure_ceilings: the L1 load rate
// (l1_GBps) and the tensor cores' TF32 rate through mma.sync (tc_tf32_GFLOPs).
//
// Kernel K4 reads its bicubic taps as 4-byte loads through the read-only
// path from a table that stays in L1 and L2; its tap term in
// kernels/roofline.k4_work is set against the rate at which an SM's L1
// returns such loads. This kernel measures that rate: every thread sums
// `iters` x 16 four-byte __ldg loads of a table of `mask + 1` floats (plus
// 16 x 32 floats of tail) small enough to stay in each SM's L1. The 32 lanes
// of a warp read 32 consecutive, 128-byte aligned floats a load; the 16
// loads of an iteration sit 32 floats apart (immediate offsets, no index
// arithmetic between them), and each iteration moves on by 17 x 32 floats,
// wrapped by `mask`, so no load repeats an address of the iteration before.
// The sums are written out so no load can be dropped. Bytes loaded over the
// kernel's time is the measured rate.
//
// Kernel K5's "v2" runs its contraction as mma.sync.m16n8k8 TF32 products,
// which kernels/roofline.k5_work(tensor_cores=True) counts as tc_flops. The
// second kernel measures the rate the tensor cores give them: every warp runs
// `iters` rounds of 8 independent products (8 accumulators, so no product
// waits on the one before) on operands held in registers; 2 x 16 x 8 x 8
// operations a product over the kernel's time is the measured rate.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 16;
constexpr int kStride = 32;

__global__ void __launch_bounds__(kThreads)
l1_load_kernel(const float* __restrict__ tab, int mask, int iters, float* __restrict__ out) {
  int at = (threadIdx.x + kStride * (blockIdx.x & 127)) & mask;
  float acc0 = 0.f, acc1 = 0.f;
  for (int it = 0; it < iters; ++it) {
    const float* p = tab + at;
#pragma unroll
    for (int k = 0; k < kLoads; k += 2) {
      acc0 += __ldg(p + k * kStride);
      acc1 += __ldg(p + (k + 1) * kStride);
    }
    at = (at + (kLoads + 1) * kStride) & mask;
  }
  out[blockIdx.x * kThreads + threadIdx.x] = acc0 + acc1;
}

constexpr int kChains = 8;

__global__ void __launch_bounds__(kThreads) mma_tf32_kernel(int iters, float* __restrict__ out) {
  // TF32 operands (low 13 bits zero) of magnitude ~1e-3: the sums stay finite
  const float x = 1e-3f * (1.f + (threadIdx.x & 31) * 0x1p-5f);
  uint32_t a[4], b[2];
  for (int k = 0; k < 4; ++k) a[k] = __float_as_uint(x * (1.f + k * 0.125f)) & 0xffffe000u;
  for (int k = 0; k < 2; ++k) b[k] = __float_as_uint(x * (1.f - k * 0.125f)) & 0xffffe000u;
  float d[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
          "{%8,%9}, {%0,%1,%2,%3};"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) sum += (d[c][0] + d[c][1]) + (d[c][2] + d[c][3]);
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

}  // namespace

// out: blocks x 256 floats; every warp runs iters x 8 mma.sync.m16n8k8 TF32
// products (2 x 16 x 8 x 8 operations each). Returns a cudaError_t.
extern "C" int gqmap_mma_tf32(void* out, int iters, int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (iters < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  mma_tf32_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// tab: (mask + 1 + 16 x 32) floats, mask + 1 a power of two and a multiple
// of 32; out: blocks x 256 floats. Returns a cudaError_t.
extern "C" int gqmap_l1_load_f32(const void* tab, void* out, int mask, int iters, int blocks,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mask < kStride - 1 || (mask & (mask + 1)) != 0 || iters < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  l1_load_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), mask, iters, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
