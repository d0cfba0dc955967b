// matmul.cuh -- hand-written kernels of the hand-tiled matrix product.
//
// Replaces the Pallas TPU kernel matmul / _matmul_kernel
// (src/repro/kernels/matmul.py): out = x @ y with a float32 accumulator,
// rounded once to the output type.
//
// What bounds it on the card: operations.  At 4096^3 the product does
// 2*m*n*k = 1.4e11 FLOP on at most 2e8 bytes: bf16 runs on the tensor
// cores (989 TFLOP/s), float32 on FFMA (67 TFLOP/s; TF32 would break the
// float32 tolerance).  Two kernels, chosen by the wrapper by a stated rule:
//
//  * wgmma_kernel (two bfloat16 inputs, k and n multiples of 8, 16-byte
//    aligned bases: TMA's stride rule).  A persistent grid, one block per
//    SM, walks the 128 x 256 output tiles.  A producer warp streams each
//    tile's K in steps of 64 through a 4-deep ring of shared tiles by TMA
//    (x as a K-major 128 x 64 box, y as four MN-major 64 x 64 boxes: y is
//    not transposed), each slot guarded by a full and an empty mbarrier.
//    Two consumer warpgroups each own 64 rows and issue wgmma m64n256k16
//    on the slot, keeping one step's products in flight while the next
//    slot fills.  TMA zero-fills the ragged edges of m, n and k; the
//    epilogue writes registers to global memory, rounded once, masked.
//  * ffma_kernel (every other input, as float32).  A 128 x 128 tile per
//    block of 256 threads, each computing an 8 x 8 micro-tile (rows ty +
//    16 i, so the two rows a warp reads lie in different banks); K in steps
//    of 16 through a 3-deep ring of cp.async copies (16 bytes a copy when
//    k and n are multiples of 4, else 4), out-of-range words zero-filled.
//    Per K step a thread reads 8 broadcast words of x and 2 LDS.128 of y
//    for 64 FFMA (x read as LDS.128 along K holds 32 more registers and
//    spills at the 128-register cap of 2 blocks per SM).
//
// The TPU grid (m/bm, n/bn, k/bk) revisits each output block across K in
// VMEM scratch; here each tile is owned by one block that loops over K
// itself.  The kernels' tiles are their own: the plan's blocks only have
// to divide the shape, as the reference asserts.
#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace hmm {

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ------------------------------------------------------------ wgmma, bf16
constexpr int WBM = 128, BN = 256, WBK = 64;
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                      // warpgroups
constexpr int WTHREADS = CONSUMERS * 128 + 32;    // + the producer warp
constexpr int A_BYTES = WBM * WBK * 2;            // 16 KB
constexpr int B_BOX = WBK * 64 * 2;               // 8 KB: 64 rows of K
constexpr int STAGE_BYTES = A_BYTES + BN / 64 * B_BOX;   // 48 KB
constexpr int WSMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

template <typename TOut>
__global__ void __launch_bounds__(WTHREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap ymap,
             TOut* __restrict__ out, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hop::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = (m + WBM - 1) / WBM * tiles_n;
  const int steps = (k + WBK - 1) / WBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], CONSUMERS * 4);   // one arrival per warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {                          // the producer warp
    if (threadIdx.x != CONSUMERS * 128) return;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * WBM, n0 = t % tiles_n * BN;
      for (int ks = 0; ks < steps; ++ks, ++it) {
        const int s = it % STAGES;
        hop::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        uint8_t* a = smem + s * STAGE_BYTES;
        hop::mbar_expect_tx(&full[s], STAGE_BYTES);
        hop::tma_load_2d(a, &xmap, &full[s], ks * WBK, m0);
        for (int j = 0; j < BN / 64; ++j)
          hop::tma_load_2d(a + A_BYTES + j * B_BOX, &ymap, &full[s],
                           n0 + 64 * j, ks * WBK);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32 % 4;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / tiles_n * WBM, n0 = t % tiles_n * BN;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    int prev = -1;
    for (int ks = 0; ks < steps; ++ks, ++it) {
      const int s = it % STAGES;
      hop::mbar_wait(&full[s], (it / STAGES) & 1);
      const uint8_t* a = smem + s * STAGE_BYTES + wg * (A_BYTES / 2);
      const uint8_t* b = smem + s * STAGE_BYTES + A_BYTES;
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WBK / 16; ++kk)
        hop::mma_ss<BN, 1>(acc, hop::desc_k(a, kk, A_BYTES),
                           hop::desc_mn(b, kk, B_BOX));
      hop::wgmma_commit();
      hop::wgmma_wait<1>();                 // the previous step is done
      hop::fence_regs(acc);
      if (prev >= 0 && lane == 0) hop::mbar_arrive(&empty[prev]);
      prev = s;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    if (prev >= 0 && lane == 0) hop::mbar_arrive(&empty[prev]);

    const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int r = r0 + 8 * ((i / 2) % 2);
      const int c = n0 + (i / 4) * 8 + 2 * (lane % 4);
      if (r < m && c < n) put2(out + (int64_t)r * n + c, acc[i], acc[i + 1]);
    }
  }
}

// Launch on `stream`; returns a CUDA error code.  The caller checks that
// x and y are bfloat16, 16-byte aligned, k % 8 == 0 and n % 8 == 0.
template <typename TOut>
int launch_wgmma(const void* x, const void* y, void* out, int m, int n,
                 int k, cudaStream_t stream) {
  CUtensorMap xmap, ymap;
  const cuuint64_t xdims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t xstride[1] = {(cuuint64_t)k * 2};
  const cuuint32_t xbox[2] = {WBK, WBM};
  const cuuint64_t ydims[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t ystride[1] = {(cuuint64_t)n * 2};
  const cuuint32_t ybox[2] = {64, WBK};
  int e = hop::make_map(&xmap, x, 2, xdims, xstride, xbox);
  if (e == 0) e = hop::make_map(&ymap, y, 2, ydims, ystride, ybox);
  if (e != 0) return e;
  cudaError_t c = cudaFuncSetAttribute(
      wgmma_kernel<TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
  if (c != cudaSuccess) return (int)c;
  const int64_t tiles =
      (int64_t)((m + WBM - 1) / WBM) * ((n + BN - 1) / BN);
  const int grid = (int)(tiles < hop::sm_count() ? tiles : hop::sm_count());
  wgmma_kernel<TOut><<<grid, WTHREADS, WSMEM, stream>>>(xmap, ymap,
                                                        (TOut*)out, m, n, k);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ FFMA, float32
constexpr int FBM = 128, FBN = 128, FBK = 16;
constexpr int FSTAGES = 3;
constexpr int FTHREADS = 256;                    // 16 x 16, 8 x 8 each
constexpr int AS = FBK + 4;                      // x rows: 16-byte aligned
constexpr int F_STAGE = FBM * AS + FBK * FBN;    // floats per ring slot
constexpr int FSMEM = FSTAGES * F_STAGE * 4;     // 55,296 B

// Stage K step `ks` into ring slot `buf`: x's 128 x 16 block and y's
// 16 x 128 block, VEC words a copy, zeros past the edges.
template <int VEC>
__device__ __forceinline__ void stage(float* buf, const float* x,
                                      const float* y, int m, int n, int k,
                                      int m0, int n0, int ks) {
  float* as = buf;
  float* bs = buf + FBM * AS;
  constexpr int XPR = FBK / VEC, YPR = FBN / VEC;   // copies per row
#pragma unroll
  for (int i = 0; i < FBM * XPR / FTHREADS; ++i) {
    const int e = threadIdx.x + i * FTHREADS;
    const int r = e / XPR, c = e % XPR * VEC;
    const int gr = m0 + r, gc = ks * FBK + c;
    const bool in = gr < m && gc < k;
    hop::cp_async<VEC * 4>(as + r * AS + c,
                           in ? x + (int64_t)gr * k + gc : x, in ? VEC * 4 : 0);
  }
#pragma unroll
  for (int i = 0; i < FBK * YPR / FTHREADS; ++i) {
    const int e = threadIdx.x + i * FTHREADS;
    const int r = e / YPR, c = e % YPR * VEC;
    const int gr = ks * FBK + r, gc = n0 + c;
    const bool in = gr < k && gc < n;
    hop::cp_async<VEC * 4>(bs + r * FBN + c,
                           in ? y + (int64_t)gr * n + gc : y, in ? VEC * 4 : 0);
  }
}

template <int VEC, typename TOut>
__global__ void __launch_bounds__(FTHREADS, 2)
ffma_kernel(const float* __restrict__ x, const float* __restrict__ y,
            TOut* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(16) float fsm[];
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int steps = (k + FBK - 1) / FBK;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < FSTAGES - 1; ++s) {
    if (s < steps) stage<VEC>(fsm + s * F_STAGE, x, y, m, n, k, m0, n0, s);
    hop::cp_async_commit();
  }
  for (int ks = 0; ks < steps; ++ks) {
    hop::cp_async_wait<FSTAGES - 2>();
    __syncthreads();              // step ks landed; slot ks - 1 is free
    const int next = ks + FSTAGES - 1;
    if (next < steps)
      stage<VEC>(fsm + next % FSTAGES * F_STAGE, x, y, m, n, k, m0, n0, next);
    hop::cp_async_commit();
    const float* as = fsm + ks % FSTAGES * F_STAGE;
    const float* bs = as + FBM * AS;
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = as[(ty + 16 * i) * AS + kk];
      const float4 b0 =
          *reinterpret_cast<const float4*>(bs + kk * FBN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * FBN + 64 + tx * 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + h * 64 + tx * 4;
      TOut* o = out + (int64_t)r * n + c;
      if (VEC == 4 && c < n) {            // n % 4 == 0: all four or none
        put2(o, acc[i][h * 4], acc[i][h * 4 + 1]);
        put2(o + 2, acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < n) put(o + j, acc[i][h * 4 + j]);
      }
    }
  }
}

// Launch on `stream`; returns a CUDA error code.  x and y are float32 and,
// for vec4, 16-byte aligned with k % 4 == 0 and n % 4 == 0.
template <typename TOut>
int launch_ffma(const void* x, const void* y, void* out, int m, int n, int k,
                int vec4, cudaStream_t stream) {
  const auto kernel =
      vec4 ? &ffma_kernel<4, TOut> : &ffma_kernel<1, TOut>;
  cudaError_t c = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FSMEM);
  if (c != cudaSuccess) return (int)c;
  dim3 grid((m + FBM - 1) / FBM, (n + FBN - 1) / FBN);
  kernel<<<grid, FTHREADS, FSMEM, stream>>>((const float*)x, (const float*)y,
                                            (TOut*)out, m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace hmm
