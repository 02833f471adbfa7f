// The L1 load-rate ceiling of kernels/roofline.measure_ceilings (l1_GBps).
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

#include <cuda_runtime.h>

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

}  // namespace

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
