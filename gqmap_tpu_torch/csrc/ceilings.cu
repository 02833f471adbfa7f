// Three ceilings of kernels/roofline.measure_ceilings: the L1 load rate
// (l1_GBps) and the tensor cores' TF32 rate through wgmma (tc_wgmma_tf32_GFLOPs,
// the rate of the bounds) and through mma.sync (tc_tf32_GFLOPs, printed beside it).
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
// Kernel K5's "v2" runs its contraction as wgmma.mma_async.m64nNk8 TF32
// products (N = 96 and 64; csrc/cheb_gq.cu), which
// kernels/roofline.k5_work(tensor_cores=True) counts as tc_flops. The wgmma
// kernel measures the rate the tensor cores give that instruction: every
// warpgroup runs `iters` rounds of 2 independent m64n96k8 products (A from
// registers, B from shared memory, as K5 v2 and tc_bench.py issue them) and
// waits for them at the end of each round; 2 x 64 x 96 x 8 operations a
// product over the kernel's time is the measured rate. The mma.sync kernel
// (the ceiling before K5 v2) runs `iters` rounds of 8 independent
// mma.sync.m16n8k8 products a warp (8 accumulators, so no product waits on
// the one before) on operands held in registers; 2 x 16 x 8 x 8 operations a
// product.

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr int kWgmmaChains = 2;

// one wgmma.mma_async.m64n96k8 TF32: d (48 floats a thread) += A (registers) B (desc)
__device__ __forceinline__ void wgmma_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, "
      "%9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// two warpgroups a CTA, each iters rounds of kWgmmaChains independent products
__global__ void __launch_bounds__(kThreads) wgmma_tf32_kernel(int iters, float* __restrict__ out) {
  __shared__ __align__(128) uint32_t bsm[96 * 8];
  for (int i = threadIdx.x; i < 96 * 8; i += blockDim.x)
    bsm[i] = __float_as_uint(1e-3f) & 0xffffe000u;
  __syncthreads();
  uint32_t a[4];
  for (int q = 0; q < 4; ++q)
    a[q] = __float_as_uint(1e-3f * (1.f + q + (threadIdx.x & 31) * 0x1p-5f)) & 0xffffe000u;
  // K-major core matrices of 8 rows x 16 bytes: 128 bytes along K, 256 along N
  const uint64_t desc = static_cast<uint64_t>((smem_u32(bsm) & 0x3ffffu) >> 4) |
                        (static_cast<uint64_t>(128 >> 4) << 16) |
                        (static_cast<uint64_t>(256 >> 4) << 32);
  float d[kWgmmaChains][48] = {};
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int c = 0; c < kWgmmaChains; ++c) wgmma_n96(d[c], a, desc);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  }
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kWgmmaChains; ++c)
#pragma unroll
    for (int i = 0; i < 48; ++i) sum += d[c][i];
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

}  // namespace

// out: blocks x 256 floats; every warpgroup (two a block) runs iters x 2
// wgmma.mma_async.m64n96k8 TF32 products (2 x 64 x 96 x 8 operations each).
// Returns a cudaError_t.
extern "C" int gqmap_wgmma_tf32(void* out, int iters, int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (iters < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  wgmma_tf32_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

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
