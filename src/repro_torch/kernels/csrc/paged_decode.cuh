// paged_decode.cuh -- hand-written kernel of one decode step of one layer
// over a paged KV cache: the KV append and the attention over the
// request's pages, fused.
//
// Replaces the Pallas TPU kernel lower_paged_decode /
// _lower_paged_decode_body (src/repro/core/codegen_pallas.py).  For each
// request b and kv head h (one block each):
//
//  1. Append.  The step's new K and V (already in the pool's type) go to
//     slot seq_len % ps of page page_table[b, seq_len / ps].  An index past
//     the table or the pool is clamped, as the reference's dynamic slices
//     clamp it.
//  2. Attend.  The request's pages are streamed with an online softmax in
//     float32 for the `group` query rows of head h: scores (q . k) * scale,
//     positions past seq_len masked to the finite -1e30, page ids clipped
//     into [0, P - 1], p NOT rounded to V's type, out = acc / l (float32).
//
// Layouts: split (two pools (P, ps, Hkv, D), K and V at head h) and fused
// (one pool (P, ps, 2 Hkv, D), K at head 2h and V at 2h + 1): the kernel
// takes a K and a V pool pointer, a head count and a head multiplier and
// offsets, so both are one code path (for fused the two pointers alias).
//
// What bounds it on the card: bytes.  Each live K/V row is read once per
// (request, kv head) and used by `group` query rows, 4 FLOP per element
// and row: for granite (group 4) 4 FLOP per byte in bf16, far below the
// card's ~295 FLOP/B.  This first version streams each block's pages
// through shared memory KC keys at a time with plain loads (no TMA, no
// cp.async) and one block per (request, kv head) -- 256 blocks for 32
// requests of 8 kv heads, fewer than 2 per SM, and no split of a long
// context across blocks (flash-decoding is later work).
//
//  * The TPU grid is sequential: its step (0, 0) seeds the output pools
//    from the input and every step then appends its own (request, head)
//    slice.  Blocks here run in no order, so the pools are updated in
//    place, and each block appends its own row, then __syncthreads(), then
//    reads its pages: the block sees its own append (a block-scope fence),
//    and no block writes a row another block of a well-formed batch reads.
//    Two requests that share a page slot (parked serving slots on the
//    reserved page 0) race there; only their own discarded rows read it.
//  * The stream stops at the last live page, ceil((seq_len + 1) / ps):
//    a page past it is fully masked and adds exact zeros (exp(-1e30 - m)
//    is 0 and alpha is 1 once a live key set m), so the result is the same
//    as streaming all n_pages_max pages as the TPU kernel does.  The online
//    softmax steps per chunk of KC keys instead of per page: the same
//    value up to float32 rounding.
//  * Threads: 4 warps.  A warp owns query rows g = warp, warp + 4, ...
//    (at most RMAX each).  Its lanes compute the scores of keys lane and
//    lane + 32 of the chunk (K staged with a padded row so those reads hit
//    distinct banks), reduce max and sum with shuffles, then own output
//    columns lane + 32 i of the row, p broadcast by shuffle.  DP, the head
//    dim rounded up to 32, is a template constant so the accumulators stay
//    in registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace pdec {

constexpr int THREADS = 128;          // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int KC = 64;                // keys staged per chunk
constexpr int GMAX = 16;              // query rows of one kv head, at most
constexpr int RMAX = GMAX / WARPS;    // rows of one warp, at most
constexpr int DMAX = 128;
constexpr int BMAX = 65535;           // requests: gridDim.y
constexpr float NEG = -1e30f;         // the TPU kernel's finite mask value

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Shared floats of one block: q (group x DP), a K chunk (KC x (DP + 1))
// and a V chunk (KC x DP).
__host__ __device__ constexpr int smem_floats(int group, int dp) {
  return group * dp + KC * (dp + 1) + KC * dp;
}

template <typename T, typename Q, int DP>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const Q* __restrict__ q, const T* __restrict__ new_k,
                    const T* __restrict__ new_v, T* kpool, T* vpool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens, float* __restrict__ out,
                    int hkv, int group, int d, int ps, int npm, int n_phys,
                    int heads, int head_mul, int k_off, int v_off,
                    float scale) {
  constexpr int NJ = DP / 32;         // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [group][DP]
  float* ks = qs + group * DP;        // [KC][DP + 1]
  float* vs = ks + KC * (DP + 1);     // [KC][DP]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ln = seq_lens[b];
  const int* pt = page_table + (int64_t)b * npm;
  const int64_t kh = (int64_t)h * head_mul + k_off;
  const int64_t vh = (int64_t)h * head_mul + v_off;

  {  // 1. append this step's K and V row
    const int page = clampi(pt[clampi(ln / ps, 0, npm - 1)], 0, n_phys - 1);
    const int64_t row = ((int64_t)page * ps + ln % ps) * heads;
    const int64_t src = ((int64_t)b * hkv + h) * d;
    for (int c = tid; c < d; c += THREADS) {
      kpool[(row + kh) * d + c] = new_k[src + c];
      vpool[(row + vh) * d + c] = new_v[src + c];
    }
  }
  const Q* qh = q + ((int64_t)b * hkv + h) * group * d;
  for (int e = tid; e < group * DP; e += THREADS) {
    const int g = e / DP, c = e % DP;
    qs[e] = c < d ? widen(qh[g * d + c]) : 0.0f;
  }
  __syncthreads();                    // the append and q are visible

  float m[RMAX], l[RMAX], acc[RMAX][NJ];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = NEG;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < NJ; ++i) acc[r][i] = 0.0f;
  }

  // 2. attend over the live pages, KC keys (KC / ps pages) at a time
  const int n_live = min(npm, ln / ps + 1);
  const int ppc = KC / ps;
  for (int p0 = 0; p0 < n_live; p0 += ppc) {
    const int keys = min(ppc, n_live - p0) * ps;
    for (int e = tid; e < keys * DP; e += THREADS) {
      const int j = e / DP, c = e % DP;
      float kv = 0.0f, vv = 0.0f;
      if (c < d) {
        const int pid = clampi(pt[p0 + j / ps], 0, n_phys - 1);
        const int64_t row = ((int64_t)pid * ps + j % ps) * heads;
        kv = widen(kpool[(row + kh) * d + c]);
        vv = widen(vpool[(row + vh) * d + c]);
      }
      ks[j * (DP + 1) + c] = kv;
      vs[j * DP + c] = vv;
    }
    __syncthreads();                  // the chunk is staged
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      const int g = warp + WARPS * r;
      if (g >= group) break;          // warp-uniform
      float s[KC / 32];
      float mx = NEG;
#pragma unroll
      for (int t = 0; t < KC / 32; ++t) {
        const int j = lane + 32 * t;
        s[t] = NEG;
        if (j < keys) {
          float dot = 0.0f;
#pragma unroll 8
          for (int c = 0; c < DP; ++c)
            dot = fmaf(qs[g * DP + c], ks[j * (DP + 1) + c], dot);
          s[t] = p0 * ps + j <= ln ? dot * scale : NEG;
          mx = fmaxf(mx, s[t]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.0f;
#pragma unroll
      for (int t = 0; t < KC / 32; ++t) {
        s[t] = lane + 32 * t < keys ? expf(s[t] - m_new) : 0.0f;
        sum += s[t];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NJ; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int t = 0; t < KC / 32; ++t) {
        for (int jj = 0; jj < 32; ++jj) {
          const int j = 32 * t + jj;
          if (j >= keys) break;       // warp-uniform
          const float p = __shfl_sync(0xffffffffu, s[t], jj);
#pragma unroll
          for (int i = 0; i < NJ; ++i)
            acc[r][i] = fmaf(p, vs[j * DP + lane + 32 * i], acc[r][i]);
        }
      }
    }
    __syncthreads();                  // the chunk's reads are done
  }

#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int g = warp + WARPS * r;
    if (g >= group) break;
    float* o = out + (((int64_t)b * hkv + h) * group + g) * d;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int c = lane + 32 * i;
      if (c < d) o[c] = acc[r][i] / l[r];   // the own token is live: l > 0
    }
  }
}

template <typename T, typename Q, int DP>
int launch_dp(const void* q, const void* new_k, const void* new_v,
              void* kpool, void* vpool, const int* page_table,
              const int* seq_lens, float* out, int batch, int hkv, int group,
              int d, int ps, int npm, int n_phys, int heads, int head_mul,
              int k_off, int v_off, float scale, cudaStream_t stream) {
  const int smem = smem_floats(group, DP) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, Q, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(hkv, batch);
  paged_decode_kernel<T, Q, DP><<<grid, THREADS, smem, stream>>>(
      (const Q*)q, (const T*)new_k, (const T*)new_v, (T*)kpool, (T*)vpool,
      page_table, seq_lens, out, hkv, group, d, ps, npm, n_phys, heads,
      head_mul, k_off, v_off, scale);
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns a CUDA error code, cudaErrorInvalidValue
// past the limits (d <= DMAX, group <= GMAX, ps <= KC, batch <= BMAX).
template <typename T, typename Q>
int launch(const void* q, const void* new_k, const void* new_v, void* kpool,
           void* vpool, const int* page_table, const int* seq_lens,
           float* out, int batch, int hkv, int group, int d, int ps, int npm,
           int n_phys, int heads, int head_mul, int k_off, int v_off,
           float scale, cudaStream_t stream) {
  using Launch = int (*)(const void*, const void*, const void*, void*, void*,
                         const int*, const int*, float*, int, int, int, int,
                         int, int, int, int, int, int, int, float,
                         cudaStream_t);
  static const Launch by_dp[DMAX / 32] = {
      &launch_dp<T, Q, 32>, &launch_dp<T, Q, 64>, &launch_dp<T, Q, 96>,
      &launch_dp<T, Q, 128>};
  if (d < 1 || d > DMAX || group < 1 || group > GMAX || ps < 1 || ps > KC ||
      batch < 1 || batch > BMAX)
    return (int)cudaErrorInvalidValue;
  return by_dp[(d + 31) / 32 - 1](q, new_k, new_v, kpool, vpool, page_table,
                                  seq_lens, out, batch, hkv, group, d, ps,
                                  npm, n_phys, heads, head_mul, k_off, v_off,
                                  scale, stream);
}

}  // namespace pdec
