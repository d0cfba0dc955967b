// tiled_gemm.cuh -- hand-written template of the tiled GEMM (paper Table 3).
//
// Replaces the Pallas TPU kernel lower_tiled_gemm
// (src/repro/core/codegen_pallas.py): out = x @ y in float32, tiled by the
// plan's (BM, BN, BK) and metapipelined at the plan's depth.
//
// What bounds it on the card: operations.  At 4096^3 the product does
// 2*m*n*k = 1.4e11 FLOP on 2e8 bytes; in float32 outside the tensor cores
// (the parity tolerance rules out TF32) the H100 peak is 67 TFLOP/s.  The
// design keeps the FMA pipes fed:
//
//  * The TPU grid revisits the output block across a K-innermost grid
//    axis.  Here each block owns one (BM, BN) output tile and loops over K
//    itself, so nothing is revisited and nothing races.
//  * The metapipeline (the paper's second optimisation): DEPTH slots in
//    shared memory, each one K slab -- x's (BM, BK) block and y's (BK, BN)
//    block -- filled with 16-byte cp.async.cg.  While slab ks is consumed,
//    slabs ks + 1 .. ks + DEPTH - 1 are in flight; one barrier per slab.
//  * A TM x TN micro-tile per thread (Micro: 8x8 where the tile then has at
//    least 128 threads, else 8x4, else 4x4): rows ty + i*TY, column quads
//    tx*4 + q*BN/NQ.  x is read along K (four K steps of a row per LDS.128)
//    and y along N (LDS.128), so a thread issues TM + 4*NQ shared loads per
//    4*TM*TN FFMA: 1 per 16 at 8x8, 1 per 8 at 4x4.
//  * Launch bounds: two blocks per SM up to 128 threads (the 64x64 tiles:
//    8x4 micro-tiles at about 170 registers); one above, so an 8x8
//    micro-tile keeps its ~170 registers instead of spilling at the
//    128-register cap of two 256-thread blocks.
//  * x rows are padded by XPAD words, so the rows a warp reads at one K
//    step fall in distinct banks.  Shared bytes: DEPTH * (BM * (BK + XPAD)
//    + BK * BN) * 4, i.e. memory.plan_memory's DEPTH * (BM*BK + BK*BN) * 4
//    for the two streamed tiles plus DEPTH * BM * XPAD * 4 of padding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tgemm {

constexpr int XPAD = 4;           // words of padding per staged x row
constexpr int MIN_THREADS = 128;  // the micro-tile rule's floor

constexpr int AK = 4;              // K steps of an x row per shared load

// AK consecutive words of an x row (16-byte aligned)
__device__ __forceinline__ void load_k(const float* p, float (&v)[AK]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

constexpr bool takes(int bm, int bn, int tm, int tn) {
  return bm % tm == 0 && bn % tn == 0 &&
         (bm / tm) * (bn / tn) >= MIN_THREADS;
}

// The shape of the template at a tile (codegen_cuda.gemm_layout is the
// same rule in Python).
template <int BM, int BN, int BK, int DEPTH>
struct Tile {
  static constexpr bool W88 = takes(BM, BN, 8, 8);
  static constexpr bool W84 = takes(BM, BN, 8, 4);
  static constexpr int TM = (W88 || W84) ? 8 : 4;
  static constexpr int TN = W88 ? 8 : 4;
  static constexpr int TX = BN / TN, TY = BM / TM, NQ = TN / 4;
  static constexpr int NT = TX * TY;                // threads
  static constexpr int AS = BK + XPAD;              // x row stride, words
  static constexpr int SLOT = BM * AS + BK * BN;    // words of one slab
  static constexpr int SMEM = DEPTH * SLOT * 4;     // bytes
  static constexpr int MIN_BLOCKS = NT <= 128 ? 2 : 1;
};

// Issue the copies of K slab `ks` into `slot`: x's (BM, BK) block and y's
// (BK, BN) block in 16-byte pieces.
template <int BM, int BN, int BK, int DEPTH>
__device__ __forceinline__ void stage(float* slot, const float* x,
                                      const float* y, int n, int k,
                                      int64_t row0, int64_t col0, int ks) {
  using L = Tile<BM, BN, BK, DEPTH>;
  constexpr int XQ = BK / 4, YQ = BN / 4;   // 16-byte pieces per row
  float* xs = slot;
  float* ys = slot + BM * L::AS;
  const int64_t k0 = (int64_t)ks * BK;
#pragma unroll
  for (int i = 0; i < (BM * XQ + L::NT - 1) / L::NT; ++i) {
    const int e = threadIdx.x + i * L::NT;
    if ((BM * XQ) % L::NT == 0 || e < BM * XQ) {
      const int r = e / XQ, c = e % XQ * 4;
      hop::cp_async<16>(xs + r * L::AS + c, x + (row0 + r) * k + k0 + c, 16);
    }
  }
#pragma unroll
  for (int i = 0; i < (BK * YQ + L::NT - 1) / L::NT; ++i) {
    const int e = threadIdx.x + i * L::NT;
    if ((BK * YQ) % L::NT == 0 || e < BK * YQ) {
      const int r = e / YQ, c = e % YQ * 4;
      hop::cp_async<16>(ys + r * BN + c, y + (k0 + r) * n + col0 + c, 16);
    }
  }
}

template <int BM, int BN, int BK, int DEPTH>
__global__ void __launch_bounds__(Tile<BM, BN, BK, DEPTH>::NT,
                                  Tile<BM, BN, BK, DEPTH>::MIN_BLOCKS)
tiled_gemm_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ out, int m, int n, int k) {
  using L = Tile<BM, BN, BK, DEPTH>;
  constexpr int TM = L::TM, TN = L::TN, NQ = L::NQ;
  extern __shared__ __align__(16) float smem[];
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;
  const int steps = k / BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < DEPTH - 1; ++s) {
    if (s < steps)
      stage<BM, BN, BK, DEPTH>(smem + s * L::SLOT, x, y, n, k, row0, col0,
                               s);
    hop::cp_async_commit();
  }
  for (int ks = 0; ks < steps; ++ks) {
    hop::cp_async_wait<DEPTH - 2>();
    __syncthreads();              // slab ks landed; slab ks - 1's slot is free
    const int next = ks + DEPTH - 1;
    if (next < steps)
      stage<BM, BN, BK, DEPTH>(smem + next % DEPTH * L::SLOT, x, y, n, k,
                               row0, col0, next);
    hop::cp_async_commit();
    const float* xs = smem + ks % DEPTH * L::SLOT;
    const float* ys = xs + BM * L::AS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += AK) {
      float a[TM][AK];
#pragma unroll
      for (int i = 0; i < TM; ++i) load_k(xs + (ty + i * L::TY) * L::AS + kk,
                                          a[i]);
#pragma unroll
      for (int s = 0; s < AK; ++s) {
        float b[TN];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(
              ys + (kk + s) * BN + q * (BN / NQ) + tx * 4);
          b[4 * q] = v.x;
          b[4 * q + 1] = v.y;
          b[4 * q + 2] = v.z;
          b[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][s], b[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* o = out + (row0 + ty + i * L::TY) * n + col0 + tx * 4;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      *reinterpret_cast<float4*>(o + q * (BN / NQ)) =
          make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                      acc[i][4 * q + 3]);
  }
}

// Launch on `stream`; returns cudaGetLastError().  The caller checks that
// BM, BN, BK divide m, n, k, that k and n are multiples of 4 and that x, y
// start on 16-byte boundaries.
template <int BM, int BN, int BK, int DEPTH>
int launch(const float* x, const float* y, float* out, int m, int n, int k,
           cudaStream_t stream) {
  using L = Tile<BM, BN, BK, DEPTH>;
  static_assert(BM % L::TM == 0 && BN % L::TN == 0 && BK % 4 == 0,
                "tile shape");
  static_assert(DEPTH >= 2, "a metapipeline has at least two slots");
  static_assert(L::NT <= 1024, "at most 1024 threads per block");
  cudaError_t e = cudaFuncSetAttribute(
      tiled_gemm_kernel<BM, BN, BK, DEPTH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n / BN, m / BM);
  tiled_gemm_kernel<BM, BN, BK, DEPTH><<<grid, L::NT, L::SMEM, stream>>>(
      x, y, out, m, n, k);
  return (int)cudaGetLastError();
}

// The template's shape at a tile: micro-tile rows and columns, threads and
// shared bytes.
template <int BM, int BN, int BK, int DEPTH>
int layout(int* v) {
  using L = Tile<BM, BN, BK, DEPTH>;
  v[0] = L::TM;
  v[1] = L::TN;
  v[2] = L::NT;
  v[3] = L::SMEM;
  return 0;
}

}  // namespace tgemm
