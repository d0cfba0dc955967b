// ssd_scan.cuh -- hand-written kernel of the Mamba-2 SSD chunked scan.
//
// Replaces the Pallas TPU kernel ssd_scan / _ssd_kernel
// (src/repro/kernels/ssd_scan.py): for x (B, S, H, Dh), dt (B, S, H),
// A (H,) and B, C (B, S, N) shared by every head, the recurrence
// h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t^T, y_t = C_t^T h_t, computed a
// chunk of L steps at a time: cum = cumsum(A dt) over the chunk, the masked
// intra-chunk term ((C B^T) o M) x with M[t][u] = exp(cum_t - cum_u) dt_u
// for u <= t, the state term exp(cum_t) C_t h, and the carry
// h' = exp(cum_L) h + (B o w)^T x with w_u = exp(cum_L - cum_u) dt_u.  All
// arithmetic is float32; the state (N, Dh) is float32; y has x's type.
//
// What bounds it on the card: at mamba2-370m's widths the bytes of x and y
// (read and written once) against 2 FMA per state element per step; this
// first version spends most of its time on the C B^T scores, which every
// block recomputes (see below).
//
//  * The TPU grid (batch, head, chunk) carries the (N, Dh) state in VMEM
//    scratch across its innermost, sequential chunk axis.  Here one block
//    owns one (batch, head, slice of ds state columns; ds the largest
//    divisor of Dh up to 16) and loops over the
//    chunks itself, so the carry never leaves the block.  Column j of the
//    state depends only on column j of x, so the slices are independent:
//    B * H * (Dh / ds) blocks instead of B * H.  Each block recomputes the
//    chunk's C B^T scores (they depend on neither the head nor the slice);
//    computing them once per batch row is later work.
//  * The plan's chunk L is staged as sub-chunks of ls steps (ls, a run-time
//    argument, is the largest divisor of L up to 64), the state carried
//    across them: the same function, exact in real arithmetic, rounded
//    differently.  At N = 128 a whole chunk of 128 steps would need 192 KB
//    for B, C and the scores alone.
//  * B and C rows sit in shared memory at an odd stride (N + 1), so the
//    score loop's reads of a warp hit distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ssd {

constexpr int THREADS = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Shared floats of one block: B and C (ls x (n + 1) each), the masked
// scores G (ls x (ls + 1)), x (ls x ds), the state (n x ds), dt, cum, w.
__host__ __device__ inline int smem_floats(int ls, int n, int ds) {
  return 2 * ls * (n + 1) + ls * (ls + 1) + ls * ds + n * ds + 3 * ls;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y, int seq, int heads,
           int dh, int n, int ls, int ds) {
  extern __shared__ float smem[];
  const int nb = n + 1;
  float* bs = smem;                   // [ls][n + 1]
  float* cs = bs + ls * nb;           // [ls][n + 1]
  float* g = cs + ls * nb;            // [ls][ls + 1]: (C B^T) o M
  float* xs = g + ls * (ls + 1);      // [ls][ds]
  float* hs = xs + ls * ds;           // [n][ds]: the carried state
  float* dts = hs + n * ds;           // [ls]
  float* cum = dts + ls;              // [ls]
  float* w = cum + ls;                // [ls]

  const int j0 = blockIdx.x * ds;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const float a = A[h];
  for (int e = threadIdx.x; e < n * ds; e += blockDim.x) hs[e] = 0.0f;

  for (int t0 = 0; t0 < seq; t0 += ls) {
    const int64_t row0 = b * seq + t0;          // first (batch, step) row
    for (int e = threadIdx.x; e < ls * n; e += blockDim.x) {
      const int t = e / n, c = e - t * n;
      bs[t * nb + c] = widen(Bm[(row0 + t) * n + c]);
      cs[t * nb + c] = widen(Cm[(row0 + t) * n + c]);
    }
    for (int e = threadIdx.x; e < ls * ds; e += blockDim.x) {
      const int t = e / ds, j = e - t * ds;
      xs[e] = widen(x[((row0 + t) * heads + h) * dh + j0 + j]);
    }
    for (int e = threadIdx.x; e < ls; e += blockDim.x)
      dts[e] = widen(dt[(row0 + e) * heads + h]);
    __syncthreads();
    if (threadIdx.x == 0) {
      float c = 0.0f;
      for (int t = 0; t < ls; ++t) {
        c += __fmul_rn(a, dts[t]);   // A dt rounded, then summed
        cum[t] = c;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < ls; e += blockDim.x)
      w[e] = expf(cum[ls - 1] - cum[e]) * dts[e];
    for (int e = threadIdx.x; e < ls * ls; e += blockDim.x) {
      const int t = e / ls, u = e - t * ls;
      float s = 0.0f;
      if (u <= t) {
        const float* ct = cs + t * nb;
        const float* bu = bs + u * nb;
        for (int c = 0; c < n; ++c) s = fmaf(ct[c], bu[c], s);
        s *= expf(cum[t] - cum[u]) * dts[u];
      }
      g[t * (ls + 1) + u] = s;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < ls * ds; e += blockDim.x) {
      const int t = e / ds, j = e - t * ds;
      const float* gt = g + t * (ls + 1);
      float intra = 0.0f;
      for (int u = 0; u <= t; ++u) intra = fmaf(gt[u], xs[u * ds + j], intra);
      const float* ct = cs + t * nb;
      float state = 0.0f;
      for (int c = 0; c < n; ++c) state = fmaf(ct[c], hs[c * ds + j], state);
      put(y + ((row0 + t) * heads + h) * dh + j0 + j,
          intra + expf(cum[t]) * state);
    }
    __syncthreads();                  // every read of the old state is done
    const float decay = expf(cum[ls - 1]);
    for (int e = threadIdx.x; e < n * ds; e += blockDim.x) {
      const int c = e / ds, j = e - c * ds;
      float add = 0.0f;
      for (int u = 0; u < ls; ++u)
        add = fmaf(bs[u * nb + c] * w[u], xs[u * ds + j], add);
      hs[e] = decay * hs[e] + add;
    }
    __syncthreads();                  // the staged chunk may be replaced
  }
}

// Launch on `stream`; returns a CUDA error code.  The caller checks that
// ls divides seq, that ds divides dh and that the grid and the shared
// memory (smem_floats) fit.
template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, int batch, int seq, int heads, int dh,
           int n, int ls, int ds, cudaStream_t stream) {
  const int smem = smem_floats(ls, n, ds) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(dh / ds, heads, batch);
  ssd_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)dt, (const float*)A, (const T*)B, (const T*)C,
      (T*)y, seq, heads, dh, n, ls, ds);
  return (int)cudaGetLastError();
}

}  // namespace ssd
