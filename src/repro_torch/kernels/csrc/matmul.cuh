// matmul.cuh -- hand-written kernel of the hand-tiled matrix product.
//
// Replaces the Pallas TPU kernel matmul / _matmul_kernel
// (src/repro/kernels/matmul.py): out = x @ y with a float32 accumulator,
// cast to the output type; x and y both float32 or both bfloat16.
//
// What bounds it on the card: operations.  At 4096^3 the product does
// 2*m*n*k = 1.4e11 FLOP on at most 2e8 bytes.  This first version
// accumulates with FFMA outside the tensor cores (no TF32: the float32
// tolerance rules it out), so its peak is the fp32 67 TFLOP/s.
//
//  * The TPU grid (m/bm, n/bn, k/bk) revisits one (bm, bn) output block
//    across its innermost K axis, accumulating in VMEM scratch.  Here one
//    block owns each (bm, bn) output tile and loops over all of K itself,
//    so nothing is revisited and nothing races.
//  * The block sizes are run-time arguments (the DSE picks them per
//    shape), so one build serves every plan.  The (bm, bn) tile is
//    computed as SUB x SUB sub-tiles in turn, rows and columns past the
//    tile's edge masked; K is staged through shared memory kc words at a
//    time, kc the largest divisor of bk up to KC_MAX (bk is the
//    divisibility grain of K, as on the TPU).  The staged bytes are 16.6 KB
//    whatever the plan: the DSE's (128, 512, 4096) plan at the card's
//    budget would need 10 MB if a whole (bm + bn) x bk block were staged.
//  * Each thread accumulates a TM x TN micro-tile (tgemm::micro_fma, as in
//    tiled_gemm.cuh).  x is staged transposed with an odd row stride, so
//    the staging stores hit distinct banks.  bfloat16 inputs are widened
//    to float32 as they are staged; the sum is rounded once, at the store.
//  * Loads and stores are scalar, neighbouring threads on neighbouring
//    words, so the inputs need no alignment beyond their type's.
//    cp.async/TMA staging and wgmma are later work.
#pragma once

#include <cuda_bf16.h>

#include "tiled_gemm.cuh"

namespace hmm {

constexpr int SUB = 64;                // rows and columns of a sub-tile
constexpr int KC_MAX = 32;             // K words staged per step, at most
constexpr int XS_STRIDE = SUB + 1;     // odd: conflict-free transposed stores
constexpr int TX = SUB / tgemm::TN;    // threads along a sub-tile's columns
constexpr int THREADS = TX * (SUB / tgemm::TM);  // 256

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const TIn* __restrict__ x, const TIn* __restrict__ y,
              TOut* __restrict__ out, int n, int k, int bm, int bn, int kc) {
  using tgemm::TM;
  using tgemm::TN;
  __shared__ float xs[KC_MAX * XS_STRIDE];          // [kk][i]: x transposed
  __shared__ __align__(16) float ys[KC_MAX * SUB];  // [kk][j]
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int64_t row0 = (int64_t)blockIdx.y * bm;
  const int64_t col0 = (int64_t)blockIdx.x * bn;

  for (int r0 = 0; r0 < bm; r0 += SUB) {
    const int rows = min(SUB, bm - r0);
    for (int c0 = 0; c0 < bn; c0 += SUB) {
      const int cols = min(SUB, bn - c0);
      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

      for (int k0 = 0; k0 < k; k0 += kc) {
        for (int e = threadIdx.x; e < SUB * kc; e += THREADS) {
          const int i = e / kc, kk = e - i * kc;
          xs[kk * XS_STRIDE + i] =
              i < rows ? widen(x[(row0 + r0 + i) * k + k0 + kk]) : 0.0f;
        }
        for (int e = threadIdx.x; e < kc * SUB; e += THREADS) {
          const int kk = e / SUB, j = e % SUB;
          ys[kk * SUB + j] =
              j < cols ? widen(y[(int64_t)(k0 + kk) * n + col0 + c0 + j])
                       : 0.0f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kc; ++kk) {
          float a[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = xs[kk * XS_STRIDE + ty * TM + i];
          const float4 b4 = reinterpret_cast<const float4*>(ys + kk * SUB)[tx];
          const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
          tgemm::micro_fma(acc, a, b);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty * TM + i;
        if (r >= rows) continue;
        TOut* o = out + (row0 + r0 + r) * n + col0 + c0;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = tx * TN + j;
          if (c < cols) put(o + c, acc[i][j]);
        }
      }
    }
  }
}

// Launch on `stream`; returns cudaGetLastError().  The caller checks that
// bm, bn and kc divide m, n and k, and that m / bm fits a grid dimension.
template <typename TIn, typename TOut>
int launch(const void* x, const void* y, void* out, int m, int n, int k,
           int bm, int bn, int kc, cudaStream_t stream) {
  dim3 grid(n / bn, m / bm);
  matmul_kernel<TIn, TOut><<<grid, THREADS, 0, stream>>>(
      (const TIn*)x, (const TIn*)y, (TOut*)out, n, k, bm, bn, kc);
  return (int)cudaGetLastError();
}

}  // namespace hmm
