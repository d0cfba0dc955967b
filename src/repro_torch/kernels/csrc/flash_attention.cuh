// flash_attention.cuh -- hand-written kernel of GQA flash attention
// (causal and sliding-window masks, queries at the tail of the keys).
//
// Replaces the Pallas TPU kernel flash_attention / _fa_kernel
// (src/repro/kernels/flash_attention.py): for q (B, Hq, Sq, D) and k, v
// (B, Hkv, Sk, D), head h reads kv head h / (Hq / Hkv); query row i sits
// at position i + Sk - Sq; a key is visible if kpos <= qpos (causal) and
// kpos > qpos - window (window).  Scores s = (q . k) * scale in float32,
// masked to the finite -1e30, and an online softmax (running max m, sum l
// and accumulator acc in float32) over the keys; p is rounded to V's type
// before the PV product, l sums the unrounded p, and out = acc / l (l == 0
// -> 1) in q's type.  A row that sees no key therefore gets the mean of V,
// as the TPU kernel gives it (exp(-1e30 + 1e30) = 1), not NaN.
//
// What bounds it on the card: operations.  The scores and the PV product
// are 4 * Sq * Sk * D FLOP per head against 2 * Sk * D words of K and V.
// This first version multiplies with FFMA outside the tensor cores (no
// TF32: the float32 tolerance rules it out), so its peak is the fp32
// 67 TFLOP/s; wgmma is later work.
//
//  * The TPU grid (b * Hkv, group, q block, kv block) carries m, l and acc
//    in VMEM scratch across its innermost kv axis.  Here one block owns one
//    (b * Hkv, group member, q tile) and loops over every kv chunk itself,
//    so nothing is revisited across blocks.  Fully masked chunks are not
//    skipped: they are what gives a row without a visible key its value.
//  * block_q, the rows a block owns, is a run-time argument; the block
//    computes them as BR-row sub-tiles in turn.  K and V are staged through
//    shared memory BC keys at a time, whatever block_k (the online softmax
//    makes the result independent of the grain up to rounding; keys past
//    Sk contribute nothing, not even to a row that sees no key).
//  * Each thread owns a 4 x 4 micro-tile of the BR x BC scores (Q and K
//    staged transposed, read as float4) and a 4 x (DP / 16) micro-tile of
//    the BR x DP output, its columns strided by 16 so the V reads of a warp
//    hit distinct banks.  The row max and sum go across the 16 threads that
//    share a row with warp shuffles.  DP, the head dim rounded up to 16, is
//    a template constant (16 ... 128), so the accumulator stays in
//    registers; columns past D are zero.
//  * Threads whose rows lie past the tile's end (decode: one row) skip the
//    arithmetic; every thread still stages K and V.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fa {

constexpr int BR = 64;              // q rows of a sub-tile
constexpr int BC = 64;              // keys staged per chunk
constexpr int TS = BR + 4;          // stride of the transposed tiles
constexpr int THREADS = 256;        // 16 x 16 threads
constexpr int DMAX = 128;
constexpr float NEG_INF = -1e30f;   // the TPU kernel's finite mask value

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// p as the PV product sees it: rounded to V's type
__device__ __forceinline__ float as_v(float p, const float*) { return p; }
__device__ __forceinline__ float as_v(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// Shared floats of one block: Q^T and K^T (DP x TS each), V (BC x DP) and
// P^T (BC x TS).
__host__ __device__ constexpr int smem_floats(int dp) {
  return 2 * dp * TS + BC * dp + BC * TS;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int group, int sq,
          int sk, int d, int block_q, float scale, int causal,
          int use_window, int window) {
  constexpr int NJ = DP / 16;         // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                   // [DP][TS]: q sub-tile, transposed
  float* kt = qt + DP * TS;           // [DP][TS]: k chunk, transposed
  float* vs = kt + DP * TS;           // [BC][DP]
  float* pt = vs + BC * DP;           // [BC][TS]: p, transposed

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // the 16 lanes that share this thread's rows (the row reductions' lanes)
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  const int g = blockIdx.y;
  const int64_t bh = blockIdx.z;      // b * Hkv + kv head
  const int64_t qhead = bh * group + g;   // b * Hq + h
  const T* qh = q + qhead * sq * d;
  const T* kh = k + bh * sk * d;
  const T* vh = v + bh * sk * d;
  T* oh = out + qhead * sq * d;
  const int q_offset = sk - sq;

  for (int r0 = 0; r0 < block_q; r0 += BR) {
    const int row0 = blockIdx.x * block_q + r0;   // first row of the sub-tile
    const int rows = min(BR, block_q - r0);
    const bool active = ty * 4 < rows;
    for (int e = threadIdx.x; e < BR * DP; e += THREADS) {
      const int r = e / DP, c = e % DP;
      qt[c * TS + r] = (r < rows && c < d)
                           ? widen(qh[(int64_t)(row0 + r) * d + c]) : 0.0f;
    }
    float m[4], l[4], acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
    }

    for (int k0 = 0; k0 < sk; k0 += BC) {
      const int keys = min(BC, sk - k0);
      __syncthreads();                // previous chunk's reads are done
      for (int e = threadIdx.x; e < BC * DP; e += THREADS) {
        const int r = e / DP, c = e % DP;
        const bool in = r < keys && c < d;
        const int64_t at = (int64_t)(k0 + r) * d + c;
        kt[c * TS + r] = in ? widen(kh[at]) : 0.0f;
        vs[r * DP + c] = in ? widen(vh[at]) : 0.0f;
      }
      __syncthreads();
      if (active) {
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
        for (int c = 0; c < DP; ++c) {
          const float4 a4 = reinterpret_cast<const float4*>(qt + c * TS)[ty];
          const float4 b4 = reinterpret_cast<const float4*>(kt + c * TS)[tx];
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
          const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
        }
        float alpha[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = row0 + ty * 4 + i + q_offset;
          float mx = NEG_INF;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = tx * 4 + j, kpos = k0 + key;
            bool vis = true;
            if (causal) vis = vis && kpos <= qpos;
            if (use_window) vis = vis && kpos > qpos - window;
            s[i][j] = vis ? s[i][j] * scale : NEG_INF;
            if (key < keys) mx = fmaxf(mx, s[i][j]);
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(half, mx, off));
          const float m_new = fmaxf(m[i], mx);
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = tx * 4 + j < keys ? expf(s[i][j] - m_new) : 0.0f;
            sum += p;
            s[i][j] = as_v(p, (const T*)nullptr);
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            sum += __shfl_xor_sync(half, sum, off);
          alpha[i] = expf(m[i] - m_new);
          l[i] = l[i] * alpha[i] + sum;
          m[i] = m_new;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float4 p4;
          p4.x = s[0][j];
          p4.y = s[1][j];
          p4.z = s[2][j];
          p4.w = s[3][j];
          reinterpret_cast<float4*>(pt + (tx * 4 + j) * TS)[ty] = p4;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha[i];
      }
      __syncthreads();                // P^T complete
      if (active) {
#pragma unroll 4
        for (int c = 0; c < keys; ++c) {
          const float4 p4 = reinterpret_cast<const float4*>(pt + c * TS)[ty];
          const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float vv = vs[c * DP + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= rows) continue;
        const float denom = l[i] == 0.0f ? 1.0f : l[i];
        T* o = oh + (int64_t)(row0 + r) * d;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 16 * j;
          if (c < d) put(o + c, acc[i][j] / denom);
        }
      }
    }
    __syncthreads();                  // q tile reads are done
  }
}

template <typename T, int DP>
int launch_dp(const void* q, const void* k, const void* v, void* out, int b,
              int hkv, int group, int sq, int sk, int d, int block_q,
              float scale, int causal, int use_window, int window,
              cudaStream_t stream) {
  const int smem = smem_floats(DP) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fa_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(sq / block_q, group, b * hkv);
  fa_kernel<T, DP><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, group, sq, sk, d,
      block_q, scale, causal, use_window, window);
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns a CUDA error code.  The caller checks that
// block_q divides sq, that d <= DMAX and that the grid fits.
template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hkv, int group, int sq, int sk, int d, int block_q,
           float scale, int causal, int use_window, int window,
           cudaStream_t stream) {
  using Launch = int (*)(const void*, const void*, const void*, void*, int,
                         int, int, int, int, int, int, float, int, int, int,
                         cudaStream_t);
  static const Launch by_dp[DMAX / 16] = {
      &launch_dp<T, 16>, &launch_dp<T, 32>, &launch_dp<T, 48>,
      &launch_dp<T, 64>, &launch_dp<T, 80>, &launch_dp<T, 96>,
      &launch_dp<T, 112>, &launch_dp<T, 128>};
  if (d < 1 || d > DMAX) return (int)cudaErrorInvalidValue;
  return by_dp[(d + 15) / 16 - 1](q, k, v, out, b, hkv, group, sq, sk, d,
                                  block_q, scale, causal, use_window, window,
                                  stream);
}

}  // namespace fa
