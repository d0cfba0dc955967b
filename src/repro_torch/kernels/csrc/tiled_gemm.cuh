// tiled_gemm.cuh -- hand-written template of the tiled GEMM (paper Table 3).
//
// Replaces the Pallas TPU kernel lower_tiled_gemm
// (src/repro/core/codegen_pallas.py): out = x @ y in float32, tiled by the
// plan's (BM, BN, BK).
//
// What bounds it on the card: operations.  At 4096^3 the product does
// 2*m*n*k = 1.4e11 FLOP on 2e8 bytes; in float32 outside the tensor cores
// (the parity tolerance rules out TF32) the H100 peak is 67 TFLOP/s.  The
// design keeps operands reused from shared memory and registers:
//
//  * The TPU grid revisits the output block across a K-innermost grid
//    axis.  Here each block owns one (BM, BN) output tile and loops over K
//    itself, so nothing is revisited and nothing races.
//  * Each K step stages a (BM, BK) tile of x and a (BK, BN) tile of y in
//    shared memory with 16-byte loads; each thread accumulates a 4 x 4
//    micro-tile in registers with fused multiply-adds.
//  * wgmma and TMA pipelining are later work.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tgemm {

constexpr int TM = 4;  // rows of the micro-tile a thread owns
constexpr int TN = 4;  // columns of the micro-tile a thread owns

// One K step of a thread's micro-tile: acc[i][j] += a[i] * b[j] with fused
// multiply-adds (shared with matmul.cuh).
__device__ __forceinline__ void micro_fma(float (&acc)[TM][TN],
                                          const float (&a)[TM],
                                          const float (&b)[TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
tiled_gemm_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ out, int m, int n, int k) {
  constexpr int TX = BN / TN;
  constexpr int NT = TX * (BM / TM);
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [BM][BK]
  float* ys = xs + BM * BK;                     // [BK][BN]
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK / 4; e += NT) {
      const int i = e / (BK / 4), q = e % (BK / 4);
      reinterpret_cast<float4*>(xs)[e] = *reinterpret_cast<const float4*>(
          x + (row0 + i) * k + k0 + 4 * q);
    }
    for (int e = threadIdx.x; e < BK * BN / 4; e += NT) {
      const int kk = e / (BN / 4), q = e % (BN / 4);
      reinterpret_cast<float4*>(ys)[e] = *reinterpret_cast<const float4*>(
          y + (int64_t)(k0 + kk) * n + col0 + 4 * q);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[(ty * TM + i) * BK + kk];
      const float4 b = reinterpret_cast<const float4*>(ys + kk * BN)[tx];
      const float bv[TN] = {b.x, b.y, b.z, b.w};
      micro_fma(acc, a, bv);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out + (row0 + ty * TM + i) * n + col0 +
                               tx * TN) = v;
  }
}

// Launch on `stream`; returns cudaGetLastError().  The caller checks that
// BM, BN, BK divide m, n, k and that k and n are multiples of 4.
template <int BM, int BN, int BK>
int launch(const float* x, const float* y, float* out, int m, int n, int k,
           cudaStream_t stream) {
  static_assert(BM % TM == 0 && BN % TN == 0 && BK % 4 == 0, "tile shape");
  constexpr int threads = (BM / TM) * (BN / TN);
  static_assert(threads <= 1024, "at most 1024 threads per block");
  constexpr int smem = (BM * BK + BK * BN) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      tiled_gemm_kernel<BM, BN, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n / BN, m / BM);
  tiled_gemm_kernel<BM, BN, BK><<<grid, threads, smem, stream>>>(x, y, out,
                                                                 m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace tgemm
