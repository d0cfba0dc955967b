// flash_attention.cuh -- hand-written kernels of GQA flash attention
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
// What bounds it on the card: operations in prefill (4 * pairs * D FLOP
// per head against 2 * Sk * D words of K and V), bytes in decode (every K
// and V byte read for one or a few query rows).
//
// Shared by both kernels:
//  * Rows are packed: the `group` query heads of one kv head are one axis
//    of group * Sq rows (row r is head r / Sq, position r % Sq), which is
//    how q and out lie in memory.  A block owns a tile of packed rows of
//    one kv head, so each K and V byte is read once per tile, not once per
//    query head: in decode all group heads share one tile.
//  * A tile loops over the 64-key chunks (BC) its rows can see, the range
//    [lo(first position), hi(last position)] of the causal and window
//    masks (live_chunks).  A fully masked chunk adds exactly 0 to a row
//    that sees a key: before its first visible chunk the masked chunks are
//    wiped by alpha = exp(-1e30 - m) = 0, after its last one p = 0.  The
//    exception is a tile holding a row that sees no key (causal with
//    Sq > Sk, or an empty window): it runs every chunk, so that row is the
//    mean of all of V, as on the TPU.
//  * Keys split: with too few tiles to fill the card, the grid's z axis
//    splits each tile's chunk range into `splits` contiguous parts; each
//    writes its float32 (m, l, acc) partials, and combine_kernel
//    (split_combine.cuh, shared with paged_decode.cuh) merges them in split
//    order (m = max m_i, l = sum l_i e^(m_i - m), acc
//    likewise, out = acc / l).  Keyless rows stay exact: every split has
//    m = -1e30, so each weighs 1 and l counts every key.
//  * The TPU grid (b * Hkv, group, q block, kv block) carries m, l, acc in
//    VMEM across its kv axis; here one block loops over its chunks itself.
//
// wgmma_kernel (three bfloat16 inputs, D % 8 == 0, 16-byte aligned):
// NWG consumer warpgroups of 64 rows each and a producer warp.  The
// producer loads the Q tile once and streams K and V chunks by TMA (3-D
// maps over (D, S, B * heads), so each head's tail is zero-filled, and D
// is zero-padded to DP = 64 or 128) into a STAGES-deep mbarrier ring.  A
// warpgroup computes S = Q K^T with wgmma m64n64k16 (A = Q and B = the K
// chunk, both K-major from shared memory), the online softmax on S's
// registers in the log2 domain (each row lies on a quad of lanes: shuffles
// 1 and 2), P rounded to bfloat16 in registers, and O += P V with wgmma
// m64nDPk16, A = P from registers, B = the V chunk, MN-major.
//
// ffma_kernel (every other input): 64-row tiles of 256 threads, each a
// 4 x 4 block of scores and a 4 x DP/16 block of the output, K and V
// staged through shared memory chunk by chunk, FFMA outside the tensor
// cores (no TF32: the float32 tolerance rules it out).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "split_combine.cuh"

namespace fa {

constexpr int BC = 64;              // keys per chunk
constexpr int BR = 64;              // packed rows of an ffma tile
constexpr int TS = BR + 4;          // stride of the transposed tiles
constexpr int THREADS = 256;        // ffma: 16 x 16 threads
constexpr int DMAX = 128;
constexpr float NEG_INF = -1e30f;   // the TPU kernel's finite mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// ------------------------------------------------------------ chunk range
using splitk::Span;

__device__ __forceinline__ bool visible(int key, int qpos, int causal,
                                        int use_window, int window) {
  return (!causal || key <= qpos) && (!use_window || key > qpos - window);
}
__device__ __forceinline__ int lo_key(int qpos, int use_window, int window) {
  return use_window ? max(0, qpos - window + 1) : 0;
}
__device__ __forceinline__ int hi_key(int qpos, int sk, int causal) {
  return causal ? min(sk - 1, qpos) : sk - 1;
}

// The chunks that split `split` of `splits` of a tile of `rows` packed
// rows from r0 runs (kernels/flash_attention.py:live_chunks is the same
// rule).  lo and hi grow with the position, so the tile's first and last
// positions bound its range, and a row that sees no key is one of them.
__device__ __forceinline__ Span live_chunks(int r0, int rows, int sq, int sk,
                                            int causal, int use_window,
                                            int window, int split,
                                            int splits) {
  const int off = sk - sq;
  int qlo = 0, qhi = sq - 1;
  if (rows < sq && r0 % sq + rows <= sq) {
    qlo = r0 % sq;
    qhi = qlo + rows - 1;
  }
  qlo += off;
  qhi += off;
  int first = 0, last = (sk + BC - 1) / BC - 1;
  const bool keyless =
      lo_key(qlo, use_window, window) > hi_key(qlo, sk, causal) ||
      lo_key(qhi, use_window, window) > hi_key(qhi, sk, causal);
  if (!keyless) {
    first = lo_key(qlo, use_window, window) / BC;
    last = hi_key(qhi, sk, causal) / BC;
  }
  return splitk::part(first, last - first + 1, split, splits);
}

// ------------------------------------------------------------ wgmma, bf16
template <int DP, int NWG>
struct WLayout {
  static constexpr int HALVES = DP / 64;          // boxes of 64 columns
  static constexpr int STAGES = DP == 64 ? 4 : 3;
  static constexpr int Q_BOX = NWG * 64 * 128;    // bytes: tile rows x 64
  static constexpr int Q_BYTES = HALVES * Q_BOX;
  static constexpr int KV_BOX = BC * 128;         // bytes: 64 keys x 64
  static constexpr int KV_BYTES = HALVES * KV_BOX;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int SMEM =
      Q_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8 + 1024;
  static constexpr int THREADS = NWG * 128 + 32;
  // head dim 64 fits two blocks on an SM (<= 112 registers a thread)
  static constexpr int MIN_BLOCKS = DP == 64 ? 2 : 1;
};

using bf16 = __nv_bfloat16;

template <int DP, int NWG>
__global__ void __launch_bounds__(WLayout<DP, NWG>::THREADS,
                                  WLayout<DP, NWG>::MIN_BLOCKS)
wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
             float* __restrict__ pm, float* __restrict__ pl,
             float* __restrict__ pacc, int group, int sq, int sk, int d,
             float scale2, int causal, int use_window, int window) {
  using L = WLayout<DP, NWG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hop::align_1024(smem_raw);
  uint8_t* ring = qs + L::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::STAGES *
                                               L::STAGE_BYTES);
  uint64_t* empty = full + L::STAGES;
  uint64_t* qfull = empty + L::STAGES;
  const int rows_total = group * sq;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * NWG * 64;  // long tiles first
  const int bh = blockIdx.y;
  const Span span =
      live_chunks(r0, min(NWG * 64, rows_total - r0), sq, sk, causal,
                  use_window, window, blockIdx.z, gridDim.z);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], NWG * 4);         // one arrival per warp
    }
    hop::mbar_init(qfull, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {                                // the producer warp
    if (threadIdx.x != NWG * 128) return;
    hop::mbar_expect_tx(qfull, L::Q_BYTES);
    for (int h = 0; h < L::HALVES; ++h)
      hop::tma_load_3d(qs + h * L::Q_BOX, &qmap, qfull, h * 64, r0, bh);
    for (int i = 0; i < span.count; ++i) {
      const int s = i % L::STAGES;
      hop::mbar_wait(&empty[s], ((i / L::STAGES) & 1) ^ 1);
      uint8_t* kt = ring + s * L::STAGE_BYTES;
      const int key0 = (span.first + i) * BC;
      hop::mbar_expect_tx(&full[s], L::STAGE_BYTES);
      for (int h = 0; h < L::HALVES; ++h) {
        hop::tma_load_3d(kt + h * L::KV_BOX, &kmap, &full[s], h * 64, key0,
                         bh);
        hop::tma_load_3d(kt + L::KV_BYTES + h * L::KV_BOX, &vmap, &full[s],
                         h * 64, key0, bh);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32 % 4;
  const int ra = r0 + wg * 64 + warp * 16 + lane / 4;   // rows ra, ra + 8
  const int qpos[2] = {ra % sq + sk - sq, (ra + 8) % sq + sk - sq};
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  const uint8_t* qw = qs + wg * 64 * 128;        // this warpgroup's rows
  hop::mbar_wait(qfull, 0);

  for (int i = 0; i < span.count; ++i) {
    const int s = i % L::STAGES;
    hop::mbar_wait(&full[s], (i / L::STAGES) & 1);
    const uint8_t* kt = ring + s * L::STAGE_BYTES;
    const uint8_t* vt = kt + L::KV_BYTES;
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.0f;
    hop::fence_regs(sc);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hop::mma_ss<64, 0>(sc, hop::desc_k(qw, kk, L::Q_BOX),
                         hop::desc_k(kt, kk, L::KV_BOX));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);

    // scores in the log2 domain, masked unless this thread's rows see the
    // whole chunk; row maxima over each quad
    const int k0 = (span.first + i) * BC, key0 = k0 + 2 * (lane % 4);
    const bool open =
        k0 + BC <= sk &&
        (!causal || k0 + BC - 1 <= min(qpos[0], qpos[1])) &&
        (!use_window || k0 > max(qpos[0], qpos[1]) - window);
    float mx[2] = {NEG_INF, NEG_INF};
    if (open) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        sc[j] *= scale2;
        mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], sc[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int key = key0 + (j / 4) * 8 + j % 2, h = (j / 2) % 2;
        const bool vis =
            key < sk && visible(key, qpos[h], causal, use_window, window);
        sc[j] = vis ? sc[j] * scale2 : NEG_INF;
        mx[h] = fmaxf(mx[h], sc[j]);
      }
    }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mx[h] = fmaxf(m[h], mx[h]);               // the new running max
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = key0 + (j / 4) * 8 + j % 2, h = (j / 2) % 2;
      sc[j] = key < sk ? exp2f(sc[j] - mx[h]) : 0.0f;
      sum[h] += sc[j];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      alpha[h] = exp2f(m[h] - mx[h]);
      l[h] = l[h] * alpha[h] + sum[h];
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) o[j] *= alpha[(j / 2) % 2];
    // P as the A operand: accumulator registers 8kk .. 8kk + 7 are the
    // m64k16 fragment of keys 16kk .. 16kk + 15
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = hop::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    hop::fence_regs(o);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hop::mma_rs<DP, 1>(o, pa[kk], hop::desc_mn(vt, kk, L::KV_BOX));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
    if (lane == 0) hop::mbar_arrive(&empty[s]);
  }

  const int64_t prows = (int64_t)gridDim.y * rows_total;   // all packed rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    if (r >= rows_total) continue;
    const int64_t at = (int64_t)bh * rows_total + r;
    if (gridDim.z == 1) {
      const float denom = l[h] == 0.0f ? 1.0f : l[h];
      bf16* orow = out + at * d;
#pragma unroll
      for (int j = 2 * h; j < DP / 2; j += 4) {
        const int c = (j / 4) * 8 + 2 * (lane % 4);
        if (c < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(o[j] / denom, o[j + 1] / denom);
      }
    } else {
      const int64_t p = blockIdx.z * prows + at;
      if (lane % 4 == 0) {
        pm[p] = m[h] * LN2;                     // back to the natural log
        pl[p] = l[h];
      }
#pragma unroll
      for (int j = 2 * h; j < DP / 2; j += 4) {
        const int c = (j / 4) * 8 + 2 * (lane % 4);
        if (c < d)
          *reinterpret_cast<float2*>(pacc + p * d + c) =
              make_float2(o[j], o[j + 1]);
      }
    }
  }
}

template <int DP, int NWG>
int launch_wgmma_dp(const void* q, const void* k, const void* v, void* out,
                    float* pm, float* pl, float* pacc, int b, int hkv,
                    int group, int sq, int sk, int d, float scale, int causal,
                    int use_window, int window, int splits,
                    cudaStream_t stream) {
  using L = WLayout<DP, NWG>;
  const cuuint64_t rows = (cuuint64_t)group * sq;
  const cuuint64_t bh = (cuuint64_t)b * hkv;
  const cuuint64_t qdims[3] = {(cuuint64_t)d, rows, bh};
  const cuuint64_t qstride[2] = {(cuuint64_t)d * 2, rows * d * 2};
  const cuuint32_t qbox[3] = {64, NWG * 64, 1};
  const cuuint64_t kdims[3] = {(cuuint64_t)d, (cuuint64_t)sk, bh};
  const cuuint64_t kstride[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)sk * d * 2};
  const cuuint32_t kbox[3] = {64, BC, 1};
  CUtensorMap qmap, kmap, vmap;
  int e = hop::make_map(&qmap, q, 3, qdims, qstride, qbox);
  if (e == 0) e = hop::make_map(&kmap, k, 3, kdims, kstride, kbox);
  if (e == 0) e = hop::make_map(&vmap, v, 3, kdims, kstride, kbox);
  if (e != 0) return e;
  cudaError_t c = cudaFuncSetAttribute(
      wgmma_kernel<DP, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (c != cudaSuccess) return (int)c;
  dim3 grid((unsigned)((rows + NWG * 64 - 1) / (NWG * 64)), (unsigned)bh,
            splits);
  wgmma_kernel<DP, NWG><<<grid, L::THREADS, L::SMEM, stream>>>(
      qmap, kmap, vmap, (bf16*)out, pm, pl, pacc, group, sq, sk, d,
      scale * LOG2E, causal, use_window, window);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- FFMA
// Shared floats of an ffma block: Q^T and K^T (DP x TS each), V (BC x DP)
// and P^T (BC x TS).
__host__ __device__ constexpr int smem_floats(int dp) {
  return 2 * dp * TS + BC * dp + BC * TS;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
ffma_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out,
            float* __restrict__ pm, float* __restrict__ pl,
            float* __restrict__ pacc, int group, int sq, int sk, int d,
            float scale, int causal, int use_window, int window) {
  constexpr int NJ = DP / 16;         // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                   // [DP][TS]: q tile, transposed
  float* kt = qt + DP * TS;           // [DP][TS]: k chunk, transposed
  float* vs = kt + DP * TS;           // [BC][DP]
  float* pt = vs + BC * DP;           // [BC][TS]: p, transposed

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // the 16 lanes that share this thread's rows (the row reductions' lanes)
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  const int rows_total = group * sq;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BR;   // long tiles first
  const int rows = min(BR, rows_total - r0);
  const int64_t bh = blockIdx.y;
  const Span span = live_chunks(r0, rows, sq, sk, causal, use_window, window,
                                blockIdx.z, gridDim.z);
  const T* qh = q + (bh * rows_total + r0) * d;
  const T* kh = k + bh * sk * d;
  const T* vh = v + bh * sk * d;
  const bool active = ty * 4 < rows;
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = (r0 + ty * 4 + i) % sq + sk - sq;

  for (int e = threadIdx.x; e < BR * DP; e += THREADS) {
    const int r = e / DP, c = e % DP;
    qt[c * TS + r] = (r < rows && c < d) ? widen(qh[(int64_t)r * d + c])
                                         : 0.0f;
  }
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int ci = 0; ci < span.count; ++ci) {
    const int k0 = (span.first + ci) * BC;
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
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = tx * 4 + j;
          const bool vis =
              visible(k0 + key, qpos[i], causal, use_window, window);
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
  if (!active) return;
  const int64_t prows = (int64_t)gridDim.y * rows_total;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    const int64_t at = bh * rows_total + r0 + r;
    if (gridDim.z == 1) {
      const float denom = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (c < d) put(out + at * d + c, acc[i][j] / denom);
      }
    } else {
      const int64_t p = blockIdx.z * prows + at;
      if (tx == 0) {
        pm[p] = m[i];
        pl[p] = l[i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (c < d) pacc[p * d + c] = acc[i][j];
      }
    }
  }
}

template <typename T, int DP>
int launch_ffma_dp(const void* q, const void* k, const void* v, void* out,
                   float* pm, float* pl, float* pacc, int b, int hkv,
                   int group, int sq, int sk, int d, float scale, int causal,
                   int use_window, int window, int splits,
                   cudaStream_t stream) {
  const int smem = smem_floats(DP) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ffma_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t rows = (int64_t)group * sq;
  dim3 grid((unsigned)((rows + BR - 1) / BR), b * hkv, splits);
  ffma_kernel<T, DP><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, pm, pl, pacc, group,
      sq, sk, d, scale, causal, use_window, window);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- launches
// Launch on `stream`; returns a CUDA error code.  The caller checks the
// shapes, d <= DMAX, b * hkv <= 65535, and for wgmma three bfloat16
// inputs, 16-byte aligned, with d % 8 == 0; `tile_rows` (64 or 128) is
// the wgmma tile, and `splits` > 1 writes partials to pm, pl, pacc.
template <typename T>
int launch_ffma(const void* q, const void* k, const void* v, void* out,
                float* pm, float* pl, float* pacc, int b, int hkv, int group,
                int sq, int sk, int d, float scale, int causal,
                int use_window, int window, int splits,
                cudaStream_t stream) {
  using Launch = int (*)(const void*, const void*, const void*, void*,
                         float*, float*, float*, int, int, int, int, int, int,
                         float, int, int, int, int, cudaStream_t);
  static const Launch by_dp[DMAX / 16] = {
      &launch_ffma_dp<T, 16>, &launch_ffma_dp<T, 32>, &launch_ffma_dp<T, 48>,
      &launch_ffma_dp<T, 64>, &launch_ffma_dp<T, 80>, &launch_ffma_dp<T, 96>,
      &launch_ffma_dp<T, 112>, &launch_ffma_dp<T, 128>};
  if (d < 1 || d > DMAX) return (int)cudaErrorInvalidValue;
  return by_dp[(d + 15) / 16 - 1](q, k, v, out, pm, pl, pacc, b, hkv, group,
                                  sq, sk, d, scale, causal, use_window,
                                  window, splits, stream);
}

inline int launch_wgmma(const void* q, const void* k, const void* v,
                        void* out, float* pm, float* pl, float* pacc, int b,
                        int hkv, int group, int sq, int sk, int d,
                        int tile_rows, float scale, int causal,
                        int use_window, int window, int splits,
                        cudaStream_t stream) {
  if (d < 8 || d > DMAX || d % 8) return (int)cudaErrorInvalidValue;
  const bool wide = tile_rows == 128;
  if (d <= 64)
    return (wide ? &launch_wgmma_dp<64, 2> : &launch_wgmma_dp<64, 1>)(
        q, k, v, out, pm, pl, pacc, b, hkv, group, sq, sk, d, scale, causal,
        use_window, window, splits, stream);
  return (wide ? &launch_wgmma_dp<128, 2> : &launch_wgmma_dp<128, 1>)(
      q, k, v, out, pm, pl, pacc, b, hkv, group, sq, sk, d, scale, causal,
      use_window, window, splits, stream);
}

}  // namespace fa
