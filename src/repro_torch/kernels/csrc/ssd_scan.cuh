// ssd_scan.cuh -- hand-written kernels of the Mamba-2 SSD chunked scan.
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
// What bounds it on the card: operations.  At mamba2-370m's widths the
// chunked algorithm does ~21.8 GFLOP (the states and their readout 8.6
// each, the intra-chunk term 4.3, the scores 0.27) on 0.27 GB of x and y:
// every product runs on FFMA (67 TFLOP/s).  Precision rule: every product
// here has a float32-derived operand (scores o M, B o w, the state, exp
// of cum) except C B^T, and C B^T is kept on FFMA too, so a bfloat16 call
// is the float32 call on its inputs widened to float32, rounded once at
// the output.  No tensor cores, no TF32.
//
// The TPU grid (batch, head, chunk) carries the state in VMEM scratch
// across its sequential chunk axis.  Here the chunked SSD's parallel form
// runs as four kernels, all but the carry parallel over chunks:
//
//  1. scores_kernel: G = C B^T once per (batch, chunk) -- not per head --
//     into a float32 workspace (batch, chunks, L, L), the 64 x 64 tiles on
//     or below the diagonal only (8.4 MB at mamba2-370m, held in L2).  The
//     first block of each (batch, chunk) also writes every head's dt and
//     cum = cumsum(A dt) (A dt rounded, then summed: a warp scan in
//     segments of 32), (batch, heads, chunks, L), which passes 2 and 4
//     then read as 2 coalesced rows instead of a strided dt and a scan.
//  2. states_kernel: S_c = (B o w)^T x per (batch, head, chunk), an N x Dh
//     float32 tile, into a workspace (batch, heads, chunks, N, Dh); the
//     block that owns tile (0, 0) also writes exp(cum_L) of its chunk.
//  3. carry_kernel: h_c = exp(cum_L) h_{c-1} + S_c, serial over the chunks
//     only, one thread per (batch, head, 4 state elements); it writes the
//     state entering each chunk, h_{c-1}, over S_c.
//  4. output_kernel: y = exp(cum) o (C h_{c-1}) + (G o M) x per (batch,
//     chunk, head), the state term first, scaled by exp(cum_t) in
//     registers, then the intra-chunk slabs up to the tile's last row.
//
// Passes 1, 2 and 4 share one block design: a 64 x 64 output tile over
// 128 threads, each an 8 x 4 register micro-tile fed by LDS.128 (8 rows of
// the K-major A operand, 4 columns of B, 32 FFMA per step).  K walks in
// slabs of 32 through a 2-slot ring: a slab arrives raw, in the input's
// type, by 16-byte cp.async (plain loads where a row is not a whole number
// of 16-byte pieces); all threads then widen it to float32 into the
// operand tiles, transposing the row-major C, B and G slabs to K-major and
// applying w_u (states) or M (output) on the way; a float32 B slab (x, or
// the state h) is multiplied where it landed.  Slab s + 1 is copied while
// slab s is widened and multiplied.  The chunk is the plan's chunk,
// whole: rows and columns past L, N or Dh are zeros.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace ssd {

constexpr int TM = 64, TN = 64;              // a block's output tile
constexpr int KS = 32;                       // K steps of a slab
constexpr int THREADS = 128;                 // 8 x 16 threads, 8 x 4 each
constexpr int RAW_BYTES = TM * (KS + 4) * 4; // one raw operand of a slot
constexpr int READY_FLOATS = KS * TM;        // one float32 operand tile

// Shared bytes of a block of chunk L: two ring slots of two raw operands,
// the two float32 operand tiles, and cum, dt and w of the chunk.
__host__ __device__ inline int smem_bytes(int L) {
  return 4 * RAW_BYTES + 2 * READY_FLOATS * 4 + 3 * L * 4;
}

struct Args {
  const void* x;      // (batch, seq, heads, dh), T
  const void* dt;     // (batch, seq, heads), T
  const float* A;     // (heads,)
  const void* B;      // (batch, seq, n), T
  const void* C;      // (batch, seq, n), T
  void* y;            // (batch, seq, heads, dh), T
  float* G;           // (batch, chunks, L, L): C B^T
  float* S;           // (batch, heads, chunks, n, dh): S_c, then h_{c-1}
  float* decay;       // (batch, heads, chunks): exp(cum_L)
  float* cum;         // (batch, heads, chunks, L): cumsum of A dt
  float* dtc;         // (batch, heads, chunks, L): dt as float32
  int batch, seq, heads, dh, n, L, chunks;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float zero_of(float) { return 0.0f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
  return __ushort_as_bfloat16(0);
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Row stride of a raw slab of R x KS elements of E (transposed later): 16
// bytes of padding, so the transposing reads of a warp spread the banks.
template <typename E>
constexpr int RAW_STRIDE = KS + 16 / (int)sizeof(E);

// Copy an R x W tile of E from `src` (rows `ld` elements apart) to `dst`
// (rows `ds` apart); elements at row >= rv or column >= cv are zeros.
// VEC: 16-byte cp.async pieces (rows and bases 16-byte aligned, cv a whole
// number of pieces), else plain element loads.
template <typename E, bool VEC, int R, int W>
__device__ __forceinline__ void load_tile(E* dst, int ds, const E* src,
                                          int64_t ld, int rv, int cv) {
  if constexpr (VEC) {
    constexpr int P = 16 / (int)sizeof(E), PR = W / P;
#pragma unroll
    for (int i = 0; i < (R * PR + THREADS - 1) / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (R * PR % THREADS && e >= R * PR) break;
      const int r = e / PR, c = e % PR * P;
      const bool in = r < rv && c < cv;
      hop::cp_async<16>(dst + r * ds + c, in ? src + r * ld + c : src,
                        in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < R * W; e += THREADS) {
      const int r = e / W, c = e % W;
      dst[r * ds + c] = r < rv && c < cv ? src[r * ld + c] : zero_of(E());
    }
  }
}

// ready[k][m] = f(m, k, raw[m][k]) for a TM x KS raw slab (rows m).
template <typename E, typename F>
__device__ __forceinline__ void transpose_in(float* ready, const E* raw,
                                             F f) {
  constexpr int RS = RAW_STRIDE<E>;
#pragma unroll
  for (int i = 0; i < TM * KS / 4 / THREADS; ++i) {
    const int g = threadIdx.x + i * THREADS;
    const int m = g % TM, k = g / TM * 4;
    float v[4];
    load4(raw + m * RS + k, v);
#pragma unroll
    for (int q = 0; q < 4; ++q) ready[(k + q) * TM + m] = f(m, k + q, v[q]);
  }
}

// ready[k][m] = f(k, raw[k][m]) for a KS x TN raw slab (rows k).
template <typename E, typename F>
__device__ __forceinline__ void straight_in(float* ready, const E* raw,
                                            F f) {
#pragma unroll
  for (int i = 0; i < KS * TN / 4 / THREADS; ++i) {
    const int g = threadIdx.x + i * THREADS;
    const int k = g / (TN / 4), m = g % (TN / 4) * 4;
    float v[4];
    load4(raw + k * TN + m, v);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = f(k, v[q]);
    store4(ready + k * TN + m, v);
  }
}

// acc += ra^T rb over one slab: rows r0..r0+7, columns c0..c0+3.
__device__ __forceinline__ void mma_slab(float (&acc)[8][4],
                                         const float* ra, const float* rb) {
  const int r0 = threadIdx.x / 16 * 8, c0 = threadIdx.x % 16 * 4;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(ra + k * TM + r0);
    const float4 a1 = *reinterpret_cast<const float4*>(ra + k * TM + r0 + 4);
    const float4 bq = *reinterpret_cast<const float4*>(rb + k * TN + c0);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The shared layout of a block; `raw(slot, op)` is op 0 (A) or 1 (B) of a
// ring slot.
struct Smem {
  unsigned char* base;
  int L;
  __device__ void* raw(int slot, int op) const {
    return base + (2 * slot + op) * RAW_BYTES;
  }
  __device__ float* ready_a() const {
    return reinterpret_cast<float*>(base + 4 * RAW_BYTES);
  }
  __device__ float* ready_b() const { return ready_a() + READY_FLOATS; }
  __device__ float* cum() const { return ready_b() + READY_FLOATS; }
  __device__ float* dts() const { return cum() + L; }
  __device__ float* w() const { return dts() + L; }
};

// The slab loop of passes 1, 2 and 4: issue(s, slot) copies slab s into a
// raw slot; ready(s, slot) widens it into the operand tiles and returns
// the B operand (the float32 tile, or the raw slot itself where it holds
// float32 as it is); before(s) runs between that and the slab's products
// and says whether this thread's rows take any (rows whose A rows are all
// zero skip them); prologue() runs while the first slab is in flight.
// Slab s + 1 is copied while slab s is widened and multiplied.
template <typename Issue, typename Ready, typename Before, typename Pro>
__device__ __forceinline__ void slab_loop(float (&acc)[8][4], int slabs,
                                          const Smem& sm, Issue issue,
                                          Ready ready, Before before,
                                          Pro prologue) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  issue(0, 0);
  hop::cp_async_commit();
  prologue();
  for (int s = 0; s < slabs; ++s) {
    hop::cp_async_wait<0>();
    __syncthreads();          // slab s landed; slab s - 1's products done
    if (s + 1 < slabs) issue(s + 1, (s + 1) & 1);
    hop::cp_async_commit();
    const float* rb = ready(s, s & 1);
    __syncthreads();          // operand tiles written
    if (before(s)) mma_slab(acc, sm.ready_a(), rb);
  }
}

// B operand rows x (KS x TN) of a straight raw slab: the slot itself for
// float32, else widened into the operand tile.
template <typename E>
__device__ __forceinline__ const float* straight_b(const Smem& sm,
                                                   const void* raw) {
  if constexpr (sizeof(E) == 4) {
    return static_cast<const float*>(raw);
  } else {
    straight_in(sm.ready_b(), static_cast<const E*>(raw),
                [](int, float v) { return v; });
    return sm.ready_b();
  }
}

// cum and dt of the chunk's L steps for one head, from the scores pass's
// workspaces, and, with `with_w`, w.  Ends with them written but not yet
// visible to other warps.
__device__ __forceinline__ void load_chunk(const Args& a, const Smem& sm,
                                           int64_t b, int h, int64_t c,
                                           bool with_w) {
  const int64_t o = ((b * a.heads + h) * a.chunks + c) * a.L;
  float* cum = sm.cum();
  float* dts = sm.dts();
  for (int t = threadIdx.x; t < a.L; t += THREADS) {
    cum[t] = a.cum[o + t];
    dts[t] = a.dtc[o + t];
  }
  if (with_w) {
    __syncthreads();
    float* w = sm.w();
    const float last = cum[a.L - 1];
    for (int u = threadIdx.x; u < a.L; u += THREADS)
      w[u] = expf(last - cum[u]) * dts[u];
  }
}

// For each head of one (batch, chunk): dt of its L steps and their cumsum
// (A dt rounded, then summed: a warp scan in segments of 32), one warp a
// head, into the workspaces (batch, heads, chunks, L).
template <typename T>
__device__ __forceinline__ void chunk_cumsums(const Args& a, int64_t bc) {
  const int64_t b = bc / a.chunks, c = bc % a.chunks;
  const T* dt = static_cast<const T*>(a.dt) + bc * a.L * a.heads;
  const int lane = threadIdx.x % 32;
  for (int h = threadIdx.x / 32; h < a.heads; h += THREADS / 32) {
    const int64_t o = ((b * a.heads + h) * a.chunks + c) * a.L;
    const float ah = a.A[h];
    float carry = 0.0f;
    for (int t0 = 0; t0 < a.L; t0 += 32) {
      const int t = t0 + lane;
      const float d = t < a.L ? widen(dt[(int64_t)t * a.heads + h]) : 0.0f;
      float v = __fmul_rn(ah, d);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      if (t < a.L) {
        a.cum[o + t] = v;
        a.dtc[o + t] = d;
      }
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
}

// ------------------------------------------------ 1. scores, C B^T
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 4) scores_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm{smem, a.L};
  const int tiles = (a.L + TM - 1) / TM;
  const int pairs = tiles * (tiles + 1) / 2;
  int p = blockIdx.x % pairs;
  const int64_t bc = blockIdx.x / pairs;        // batch * chunks + chunk
  if (p == 0) chunk_cumsums<T>(a, bc);
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
  const int tu = p - ti * (ti + 1) / 2;
  const int t0 = ti * TM, u0 = tu * TN;
  const int64_t row0 = bc * a.L;                // (batch, step) row
  const T* C = static_cast<const T*>(a.C) + row0 * a.n;
  const T* B = static_cast<const T*>(a.B) + row0 * a.n;
  constexpr int RS = RAW_STRIDE<T>;
  float acc[8][4];
  slab_loop(
      acc, (a.n + KS - 1) / KS, sm,
      [&](int s, int slot) {
        const int k0 = s * KS;
        load_tile<T, VEC, TM, KS>(static_cast<T*>(sm.raw(slot, 0)), RS,
                                  C + (int64_t)t0 * a.n + k0, a.n,
                                  a.L - t0, a.n - k0);
        load_tile<T, VEC, TM, KS>(static_cast<T*>(sm.raw(slot, 1)), RS,
                                  B + (int64_t)u0 * a.n + k0, a.n,
                                  a.L - u0, a.n - k0);
      },
      [&](int, int slot) {
        auto id = [](int, int, float v) { return v; };
        transpose_in(sm.ready_a(), static_cast<const T*>(sm.raw(slot, 0)),
                     id);
        transpose_in(sm.ready_b(), static_cast<const T*>(sm.raw(slot, 1)),
                     id);
        return static_cast<const float*>(sm.ready_b());
      },
      [](int) { return true; }, [] {});
  const int r0 = threadIdx.x / 16 * 8, c0 = threadIdx.x % 16 * 4;
  float* G = a.G + row0 * a.L;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + r0 + i, u = u0 + c0;
    if (t >= a.L || u >= a.L) continue;
    float* g = G + (int64_t)t * a.L + u;
    if (VEC) {
      store4(g, acc[i]);
    } else {
      for (int j = 0; j < 4 && u + j < a.L; ++j) g[j] = acc[i][j];
    }
  }
}

// ------------------------------------------------ 2. chunk states
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 4) states_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm{smem, a.L};
  const int kt = (a.n + TM - 1) / TM, jt = (a.dh + TN - 1) / TN;
  const int h = blockIdx.y;
  const int ji = blockIdx.x % jt, ki = blockIdx.x / jt % kt;
  const int64_t bc = blockIdx.x / jt / kt;
  const int64_t b = bc / a.chunks, c = bc % a.chunks;
  const int k0 = ki * TM, j0 = ji * TN;
  const int64_t row0 = bc * a.L;
  const T* B = static_cast<const T*>(a.B) + row0 * a.n + k0;
  const T* x = static_cast<const T*>(a.x) + row0 * a.heads * a.dh +
               (int64_t)h * a.dh + j0;
  const int64_t xld = (int64_t)a.heads * a.dh;
  float acc[8][4];
  slab_loop(
      acc, (a.L + KS - 1) / KS, sm,
      [&](int s, int slot) {
        const int u0 = s * KS;
        load_tile<T, VEC, KS, TM>(static_cast<T*>(sm.raw(slot, 0)), TM,
                                  B + (int64_t)u0 * a.n, a.n, a.L - u0,
                                  a.n - k0);
        load_tile<T, VEC, KS, TN>(static_cast<T*>(sm.raw(slot, 1)), TN,
                                  x + u0 * xld, xld, a.L - u0, a.dh - j0);
      },
      [&](int s, int slot) {
        const int u0 = s * KS;
        const float* w = sm.w();
        const int L = a.L;
        straight_in(sm.ready_a(), static_cast<const T*>(sm.raw(slot, 0)),
                    [&](int k, float v) {
                      return u0 + k < L ? v * w[u0 + k] : 0.0f;
                    });
        return straight_b<T>(sm, sm.raw(slot, 1));
      },
      [](int) { return true; }, [&] { load_chunk(a, sm, b, h, c, true); });
  if (ki == 0 && ji == 0 && threadIdx.x == 0)
    a.decay[(b * a.heads + h) * a.chunks + c] = expf(sm.cum()[a.L - 1]);
  const int r0 = threadIdx.x / 16 * 8, c0 = threadIdx.x % 16 * 4;
  float* S = a.S + ((b * a.heads + h) * a.chunks + c) * a.n * a.dh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + r0 + i, j = j0 + c0;
    if (k >= a.n || j >= a.dh) continue;
    float* o = S + (int64_t)k * a.dh + j;
    if (VEC) {
      store4(o, acc[i]);
    } else {
      for (int q = 0; q < 4 && j + q < a.dh; ++q) o[q] = acc[i][q];
    }
  }
}

// ------------------------------------------------ 3. the carry
// One thread per (batch, head, V state elements; V = 4 where a chunk's
// state is a whole number of float4s): walks the chunks in order, writing
// the state that enters chunk c over S_c.  The loads of CHUNKS_AHEAD
// chunks are issued before their stores, so each thread keeps 128 bytes
// in flight (one chunk at a time left the carry latency-bound).
constexpr int CARRY_THREADS = 256, CHUNKS_AHEAD = 8;

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    load4(p, v);
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    store4(p, v);
  } else {
    *p = v[0];
  }
}

template <int V>
__global__ void __launch_bounds__(CARRY_THREADS) carry_kernel(Args a) {
  const int64_t per = (int64_t)a.n * a.dh;
  const int64_t g = ((int64_t)blockIdx.x * CARRY_THREADS + threadIdx.x) * V;
  if (g >= (int64_t)a.batch * a.heads * per) return;
  const int64_t bh = g / per;
  float* p = a.S + bh * a.chunks * per + g % per;
  const float* decay = a.decay + bh * a.chunks;
  float h[V];
#pragma unroll
  for (int v = 0; v < V; ++v) h[v] = 0.0f;
  for (int c0 = 0; c0 < a.chunks; c0 += CHUNKS_AHEAD) {
    float s[CHUNKS_AHEAD][V], d[CHUNKS_AHEAD];
#pragma unroll
    for (int i = 0; i < CHUNKS_AHEAD; ++i)
      if (c0 + i < a.chunks) {
        load_v<V>(p + (c0 + i) * per, s[i]);
        d[i] = decay[c0 + i];
      }
#pragma unroll
    for (int i = 0; i < CHUNKS_AHEAD; ++i)
      if (c0 + i < a.chunks) {
        store_v<V>(p + (c0 + i) * per, h);
#pragma unroll
        for (int v = 0; v < V; ++v)
          h[v] = __fadd_rn(__fmul_rn(d[i], h[v]), s[i][v]);
      }
  }
}

// ------------------------------------------------ 4. the output
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 4) output_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm{smem, a.L};
  const int tt = (a.L + TM - 1) / TM, jt = (a.dh + TN - 1) / TN;
  const int h = blockIdx.y;
  const int ji = blockIdx.x % jt, ti = blockIdx.x / jt % tt;
  const int64_t bc = blockIdx.x / jt / tt;
  const int64_t b = bc / a.chunks, c = bc % a.chunks;
  const int t0 = ti * TM, j0 = ji * TN;
  const int64_t row0 = bc * a.L;
  const T* C = static_cast<const T*>(a.C) + (row0 + t0) * a.n;
  const float* Hs = a.S + ((b * a.heads + h) * a.chunks + c) * a.n * a.dh +
                    j0;
  const float* G = a.G + (row0 + t0) * a.L;
  const int64_t xld = (int64_t)a.heads * a.dh;
  const T* x = static_cast<const T*>(a.x) + row0 * xld + (int64_t)h * a.dh +
               j0;
  const int ns = (a.n + KS - 1) / KS;               // state slabs
  const int last = t0 + TM < a.L ? t0 + TM : a.L;   // u < last
  constexpr int RS = RAW_STRIDE<T>, RSF = RAW_STRIDE<float>;
  const int r0 = threadIdx.x / 16 * 8;
  float acc[8][4];
  slab_loop(
      acc, ns + (last + KS - 1) / KS, sm,
      [&](int s, int slot) {
        if (s < ns) {
          const int k0 = s * KS;
          load_tile<T, VEC, TM, KS>(static_cast<T*>(sm.raw(slot, 0)), RS,
                                    C + k0, a.n, a.L - t0, a.n - k0);
          load_tile<float, VEC, KS, TN>(
              static_cast<float*>(sm.raw(slot, 1)), TN,
              Hs + (int64_t)k0 * a.dh, a.dh, a.n - k0, a.dh - j0);
        } else {
          const int u0 = (s - ns) * KS;
          load_tile<float, VEC, TM, KS>(static_cast<float*>(sm.raw(slot, 0)),
                                        RSF, G + u0, a.L, a.L - t0,
                                        a.L - u0);
          load_tile<T, VEC, KS, TN>(static_cast<T*>(sm.raw(slot, 1)), TN,
                                    x + u0 * xld, xld, a.L - u0, a.dh - j0);
        }
      },
      [&](int s, int slot) {
        if (s < ns) {
          transpose_in(sm.ready_a(), static_cast<const T*>(sm.raw(slot, 0)),
                       [](int, int, float v) { return v; });
          return static_cast<const float*>(sm.raw(slot, 1));
        } else {
          const int u0 = (s - ns) * KS;
          const float* cum = sm.cum();
          const float* dts = sm.dts();
          const int L = a.L;
          transpose_in(sm.ready_a(),
                       static_cast<const float*>(sm.raw(slot, 0)),
                       [&](int m, int k, float g) {
                         const int t = t0 + m, u = u0 + k;
                         return u <= t && t < L
                                    ? g * (expf(cum[t] - cum[u]) * dts[u])
                                    : 0.0f;
                       });
          return straight_b<T>(sm, sm.raw(slot, 1));
        }
      },
      [&](int s) {
        if (s == ns) {              // the state term done: exp(cum_t) (C h)
          const float* cum = sm.cum();
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int t = t0 + r0 + i;
            const float e = t < a.L ? expf(cum[t]) : 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] *= e;
          }
        }
        // an intra-chunk slab's M is zero above the diagonal: rows all
        // before its first step skip it (exactly: their products are 0)
        return s < ns || t0 + r0 + 7 >= (s - ns) * KS;
      },
      [&] { load_chunk(a, sm, b, h, c, false); });
  const int c0 = threadIdx.x % 16 * 4;
  T* y = static_cast<T*>(a.y) + row0 * xld + (int64_t)h * a.dh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + r0 + i, j = j0 + c0;
    if (t >= a.L || j >= a.dh) continue;
    T* o = y + (int64_t)t * xld + j;
    if (VEC) {
      store4(o, acc[i]);
    } else {
      for (int q = 0; q < 4 && j + q < a.dh; ++q) put(o + q, acc[i][q]);
    }
  }
}

// ------------------------------------------------ host
enum Pass { SCORES = 0, STATES = 1, CARRY = 2, OUTPUT = 3 };

template <typename K>
int prepare(K kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

// Launch one pass on `stream`; returns a CUDA error code.  The caller
// checks that L divides seq, that the grid and smem_bytes(L) fit and, for
// VEC, that every base is 16-byte aligned and N and Dh times the element
// size and L times 4 are multiples of 16 bytes.
template <typename T, bool VEC>
int launch_pass(int pass, const Args& a, cudaStream_t stream) {
  const int64_t bc = (int64_t)a.batch * a.chunks;
  const int tiles = (a.L + TM - 1) / TM, jt = (a.dh + TN - 1) / TN;
  if (pass == CARRY) {
    const int64_t words = (int64_t)a.batch * a.heads * a.n * a.dh;
    const bool v4 = (int64_t)a.n * a.dh % 4 == 0;
    const int64_t threads = v4 ? words / 4 : words;
    const unsigned grid =
        (unsigned)((threads + CARRY_THREADS - 1) / CARRY_THREADS);
    if (v4)
      carry_kernel<4><<<grid, CARRY_THREADS, 0, stream>>>(a);
    else
      carry_kernel<1><<<grid, CARRY_THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int smem = smem_bytes(a.L);
  int e;
  if (pass == SCORES) {
    e = prepare(scores_kernel<T, VEC>, smem);
    if (e) return e;
    scores_kernel<T, VEC><<<(unsigned)(bc * (tiles * (tiles + 1) / 2)),
                            THREADS, smem, stream>>>(a);
  } else if (pass == STATES) {
    e = prepare(states_kernel<T, VEC>, smem);
    if (e) return e;
    const dim3 grid((unsigned)(bc * ((a.n + TM - 1) / TM) * jt), a.heads);
    states_kernel<T, VEC><<<grid, THREADS, smem, stream>>>(a);
  } else {
    e = prepare(output_kernel<T, VEC>, smem);
    if (e) return e;
    const dim3 grid((unsigned)(bc * tiles * jt), a.heads);
    output_kernel<T, VEC><<<grid, THREADS, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace ssd
