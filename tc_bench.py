"""The H100's TF32 tensor-core instructions as kernel K5 "v2" uses them.

    python tc_bench.py

Needs one Hopper card and nvcc. It builds two small kernels (their source is
below) into ``gqmap_tpu_torch/_build/`` and prints, with the card's name and
power limit:

1. ``mma.sync.m16n8k8`` TF32: the cycles an SM sub-partition spends on a
   round of 4 independent products alone, and with N independent FMAs issued
   among them (N = 0, 8, 16, 32, 64), at 1, 2 and 4 warps a sub-partition:
   whether the FMA pipe works while the tensor cores do;
2. ``wgmma.mma_async.m64nNk8`` TF32 (A from registers, B from shared memory),
   N = 32 and 96: the cycles a warpgroup spends a wgmma when each one waits
   for the last (a dependent chain), and with C independent accumulators
   between waits, at 1 and 2 warpgroups an SM, and the TFLOP/s.

One CTA an SM; times by CUDA events over 3 launches after one warm-up.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a round: 4 independent mma.sync chains, N / 4 independent FMAs after each
template <int N>
__global__ void mma_ffma(int iters, float* out) {
  const float x = 1e-3f * (1.f + (threadIdx.x & 31) * 0x1p-5f);
  uint32_t a[4], b[2];
  for (int q = 0; q < 4; ++q) a[q] = __float_as_uint(x * (1.f + q * 0.125f)) & 0xffffe000u;
  for (int q = 0; q < 2; ++q) b[q] = __float_as_uint(x * (1.f - q * 0.125f)) & 0xffffe000u;
  float d[4][4] = {}, f[8];
  for (int q = 0; q < 8; ++q) f[q] = x * q;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
          "{%8,%9}, {%0,%1,%2,%3};"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#pragma unroll
      for (int q = 0; q < N / 4; ++q)
        asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(f[q & 7]) : "f"(0.999f), "f"(1e-4f));
    }
  }
  float s = 0.f;
  for (int c = 0; c < 4; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  for (int q = 0; q < 8; ++q) s += f[q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc);
template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, "
      "%9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t desc) {
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

// a round: C wgmmas into C accumulators, then a wait for all of them
template <int N, int C>
__global__ void wgmma_chain(int iters, float* out) {
  __shared__ __align__(128) uint32_t bsm[96 * 8];
  for (int i = threadIdx.x; i < 96 * 8; i += blockDim.x)
    bsm[i] = __float_as_uint(1e-3f) & 0xffffe000u;
  __syncthreads();
  uint32_t a[4];
  for (int q = 0; q < 4; ++q) a[q] = __float_as_uint(1e-3f * (1 + q)) & 0xffffe000u;
  // K-major core matrices of 8 rows x 16 bytes: 128 bytes along K, 256 along N
  const uint64_t desc = static_cast<uint64_t>((smem_u32(bsm) & 0x3ffffu) >> 4) |
                        (static_cast<uint64_t>(128 >> 4) << 16) |
                        (static_cast<uint64_t>(256 >> 4) << 32);
  float d[C][N / 2] = {};
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int c = 0; c < C; ++c) wgmma<N>(d[c], a, desc);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  }
  float s = 0.f;
  for (int c = 0; c < C; ++c)
    for (int i = 0; i < N / 2; ++i) s += d[c][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename F>
static float time_ms(F launch) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  launch();
  cudaEventRecord(e0);
  for (int r = 0; r < 3; ++r) launch();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return ms / 3;
}

// case: FMAs a round of 4 mma.sync (0, 8, 16, 32, 64); returns ms, or -1
extern "C" float tc_mma_ffma(int ffma, int warps_per_sm, int iters, float* out) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  auto run = [&](auto kernel) {
    return time_ms([&] { kernel<<<sms, 32 * warps_per_sm>>>(iters, out); });
  };
  float ms = -1.f;
  switch (ffma) {
    case 0: ms = run(mma_ffma<0>); break;
    case 8: ms = run(mma_ffma<8>); break;
    case 16: ms = run(mma_ffma<16>); break;
    case 32: ms = run(mma_ffma<32>); break;
    case 64: ms = run(mma_ffma<64>); break;
  }
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}

// n: 32 or 96; chains: 1, 2 or 6 (n 32) / 1, 2 (n 96); returns ms, or -1
extern "C" float tc_wgmma(int n, int chains, int warpgroups, int iters, float* out) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  auto run = [&](auto kernel) {
    return time_ms([&] { kernel<<<sms, 128 * warpgroups>>>(iters, out); });
  };
  float ms = -1.f;
  if (n == 32 && chains == 1) ms = run(wgmma_chain<32, 1>);
  if (n == 32 && chains == 2) ms = run(wgmma_chain<32, 2>);
  if (n == 32 && chains == 6) ms = run(wgmma_chain<32, 6>);
  if (n == 96 && chains == 1) ms = run(wgmma_chain<96, 1>);
  if (n == 96 && chains == 2) ms = run(wgmma_chain<96, 2>);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
"""


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tc_bench: no CUDA device")
    from gqmap_tpu_torch.kernels import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    clock_hz = float(card.split(",")[-1].split()[0]) * 1e6
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        src, lib = os.path.join(tmp, "tc_bench.cu"), os.path.join(tmp, "libtc_bench.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([build._find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", lib, src],
                       check=True, capture_output=True)
        so = ctypes.CDLL(lib)
        so.tc_mma_ffma.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        so.tc_wgmma.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        so.tc_mma_ffma.restype = so.tc_wgmma.restype = ctypes.c_float
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        out = torch.empty(sms * 1024, device="cuda")
        iters = 8192
        for warps in (4, 8, 16):  # 1, 2, 4 a sub-partition
            for ffma in (0, 8, 16, 32, 64):
                ms = so.tc_mma_ffma(ffma, warps, iters, out.data_ptr())
                rounds = iters * warps / 4  # rounds a sub-partition
                print(f"mma.sync TF32, {warps // 4} warp(s) a sub-partition, {ffma:2d} FMAs a "
                      f"round of 4 products: {ms * 1e-3 * clock_hz / rounds:.1f} cycles a round")
        iters = 2048
        for n, chains in ((32, 1), (32, 2), (32, 6), (96, 1), (96, 2)):
            for wgs in (1, 2):
                ms = so.tc_wgmma(n, chains, wgs, iters, out.data_ptr())
                flop = sms * wgs * iters * chains * 2.0 * 64 * n * 8
                print(f"wgmma m64n{n}k8 TF32, {wgs} warpgroup(s) an SM, {chains} accumulator(s) "
                      f"a wait: {ms * 1e-3 * clock_hz / (iters * chains):.1f} cycles a wgmma a "
                      f"warpgroup, {flop / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
        torch.cuda.synchronize()


if __name__ == "__main__":
    sys.exit(main())
