// paged_decode.cuh -- hand-written kernels of one decode step of one layer
// over a paged KV cache: the KV append and the attention over the
// request's pages, fused, with the request's context split across blocks
// (flash-decoding).
//
// Replaces the Pallas TPU kernel lower_paged_decode /
// _lower_paged_decode_body (src/repro/core/codegen_pallas.py).  For each
// request b, kv head h and split s (one block each, grid (Hkv, B, splits)):
//
//  1. Append.  The step's new K and V (already in the pool's type) go to
//     slot seq_len % ps of page page_table[b, seq_len / ps].  An index past
//     the table or the pool is clamped, as the reference's dynamic slices
//     clamp it.  That slot is position A = clamp(seq_len / ps, 0, npm - 1)
//     * ps + seq_len % ps of the request (seq_len itself unless seq_len
//     runs past the table).
//  2. Attend.  The request's live pages, ceil((seq_len + 1) / ps) of them
//     (the rest are fully masked and add exact zeros), in chunks of KC / ps
//     pages; the chunks are cut into `splits` contiguous parts
//     (splitk::part of the request's own chunk count, so a short request's
//     blocks finish early) and part s streams with an online softmax in
//     float32 for the `group` query rows of head h: scores (q . k) * scale,
//     positions past seq_len masked to the finite -1e30, page ids clipped
//     into [0, P - 1], p NOT rounded to V's type.  One split writes out =
//     acc / l (float32); more write (m, l, acc) partials that
//     splitk::combine_kernel merges in split order.
//
// Blocks run in no order, so no block depends on another's append: the
// block of the last split (whose part holds position A, on the last live
// page) writes the new K/V row into the pool, and every block whose chunk
// holds A stages that key's K and V from new_k / new_v instead of the pool.
// No other block of a well-formed batch reads that slot.  Parked serving
// requests (every table entry the reserved page 0, seq_len 0) all append
// to page 0's slot 0: those writes race (each element of the slot ends up
// one of theirs), and only their own discarded outputs read it, each from
// its own new_k / new_v.
//
// Layouts: split (two pools (P, ps, Hkv, D), K and V at head h) and fused
// (one pool (P, ps, 2 Hkv, D), K at head 2h and V at 2h + 1): the kernel
// takes a K and a V pool pointer, a head count and a head multiplier and
// offsets, so both are one code path (for fused the two pointers alias).
//
// What bounds it on the card: bytes.  Each live K/V row is read once per
// (request, kv head) and used by `group` query rows, 4 FLOP per element
// and row: for granite (group 4) 4 FLOP per byte in bf16, far below the
// card's ~295 FLOP/B.  So the design keeps loads in flight:
//
//  * Pages arrive by 16-byte cp.async.cg into a ring of STAGES chunk slots
//    kept in the pool's type (widened to f32 at use): chunk c + 1 is in
//    flight while chunk c is scored.  A chunk's page ids are read once per
//    warp (one coalesced load, a chunk ahead) and passed by shuffle.
//  * Splits put enough blocks in flight (codegen_cuda.paged_splits); the
//    block is 4 warps.
//  * Scores and PV share one thread layout: LPK lanes (a power of two,
//    LPK * EPP >= d) own EPP head-dim elements of one key each (epp(): 8,
//    one LDS.128, in a bf16 pool with up to 8 rows, else 4), THREADS /
//    LPK keys at a time.  q's elements live in registers; a score is an
//    EPP-long dot and a reduction over the LPK lanes that halves the rows
//    each lane carries (row_sums: ~G shuffles per key, not G log2 LPK).
//    Softmax runs per row over the chunk's scores in shared memory (key
//    major, so PV reads 4 rows' p per LDS.128; warp w owns rows w, w + 4,
//    ...), then each lane adds p * v to its own register accumulator; the
//    key subsets' accumulators are summed once, at the end.
//  * A thread copies one fixed 16-byte piece of every R-th key row
//    (CopyLane), so staging a chunk costs no integer division.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "split_combine.cuh"

namespace pdec {

constexpr int THREADS = 128;          // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int KC = 64;                // keys per chunk
constexpr int STAGES = 2;             // chunk slots in the ring
constexpr int GMAX = 16;              // query rows of one kv head, at most
constexpr int DMAX = 128;
constexpr int BMAX = 65535;           // requests: gridDim.y
constexpr int SMAX = 64;              // splits: gridDim.z
constexpr float NEG = -1e30f;         // the TPU kernel's finite mask value

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Head-dim elements a lane owns: 8 (one LDS.128) in a bfloat16 pool with
// at most 8 query rows, else 4 (the registers of 16 rows' q and acc).
template <typename T, int G>
__host__ __device__ constexpr int epp() {
  return sizeof(T) == 2 && G <= 8 ? 8 : 4;
}

// N elements at p (N * sizeof(T)-byte aligned shared memory), widened
__device__ __forceinline__ void load_n(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p,
                                       float (&v)[N]) {
  static_assert(N == 4 || N == 8, "4 or 8 bfloat16");
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
  } else {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x, w[1] = t.y;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Shared bytes of one block: the ring (STAGES x {K, V} x KC rows of d
// elements of T), then the chunk's scores (KC x G) and m, l, alpha (G each)
// in float32.  The final reduction (WARPS x G x d floats) reuses the ring.
template <typename T, int G>
__host__ __device__ constexpr int smem_bytes(int d) {
  return STAGES * 2 * KC * d * (int)sizeof(T) + (G * KC + 3 * G) * 4;
}

// Where one block reads and writes.
struct Args {
  int hkv, group, d, ps, npm, n_phys, heads, head_mul, k_off, v_off, lpk;
  float scale;
};

// This warp's page ids of chunk c (pages c * ppc + lane and + 32 of the
// `live` pages), clipped into the pool.
__device__ __forceinline__ void chunk_ids(const int* pt, int c, int ppc,
                                          int live, int n_phys, int lane,
                                          int (&id)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = c * ppc + lane + 32 * i;
    id[i] = (lane + 32 * i < ppc && p < live)
                ? clampi(pt[p], 0, n_phys - 1) : 0;
  }
}

// A thread's share of a chunk's copies, fixed for the whole kernel:
// 16-byte piece `piece` of key rows crow, crow + rows, ... of K and of V;
// (pg0, s0) is row crow's page in the chunk and slot in that page, (dpg,
// ds) the same for a step of `rows` rows.  A thread with crow >= rows
// (when the pieces of a row do not divide THREADS) copies nothing.
struct CopyLane {
  int piece, crow, rows, pg0, s0, dpg, ds;
};

__device__ __forceinline__ CopyLane copy_lane(int d, int ps, int vec) {
  const int ppr = d / vec;            // pieces per key row
  CopyLane c;
  c.piece = threadIdx.x % ppr;
  c.crow = threadIdx.x / ppr;
  c.rows = THREADS / ppr;
  c.pg0 = c.crow / ps;
  c.s0 = c.crow % ps;
  c.dpg = c.rows / ps;
  c.ds = c.rows % ps;
  return c;
}

// Issue the 16-byte copies of chunk c (its `keys` keys, K then V) into
// ring slot `slot`; position `app` comes from new_k / new_v.  The page of
// a row is this warp's id of it (chunk_ids), passed by shuffle.
template <typename T>
__device__ __forceinline__ void stage(T* slot, const T* kpool,
                                      const T* vpool, const T* nk,
                                      const T* nv, const Args& a,
                                      const CopyLane& cl, int c, int ppc,
                                      int keys, int app, int64_t kh,
                                      int64_t vh, const int (&id)[2]) {
  constexpr int VEC = 16 / (int)sizeof(T);    // elements of one copy
  const int key0 = c * ppc * a.ps;
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    const T* pool = kv ? vpool : kpool;
    const int64_t head = kv ? vh : kh;
    int pg = cl.pg0, sl = cl.s0;
    for (int jb = 0; jb < keys; jb += cl.rows) {
      const int j = jb + cl.crow;
      const int lo = __shfl_sync(0xffffffffu, id[0], pg & 31);
      const int hi = __shfl_sync(0xffffffffu, id[1], pg & 31);
      if (j < keys && cl.crow < cl.rows) {
        const T* src =
            key0 + j == app
                ? (kv ? nv : nk) + cl.piece * VEC
                : pool + ((((int64_t)(pg < 32 ? lo : hi) * a.ps + sl) *
                               a.heads + head) * a.d + cl.piece * VEC);
        hop::cp_async<16>(slot + (kv * KC + j) * a.d + cl.piece * VEC, src,
                          16);
      }
      sl += cl.ds;
      pg += cl.dpg;
      if (sl >= a.ps) {
        sl -= a.ps;
        ++pg;
      }
    }
  }
}

// One halving step of row_sums and the steps after it, unrolled at
// compile time (H rows move at this step): if a shuffle distance is
// left, a lane keeps half of its 2H rows and adds its partner's half.
template <int G, int H>
__device__ __forceinline__ void halve(float (&v)[G], int piece, int& off,
                                      int& base, int& n) {
  if constexpr (H >= 1) {
    if (off > 0) {                    // uniform: lpk is the block's
      const bool up = piece & off;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      if (up) base += H;
      n = H;
      off /= 2;
    }
    halve<G, H / 2>(v, piece, off, base, n);
  }
}

// The G rows' partial dots v of one key, summed over the key's lpk lanes
// (a power of two) by halving: at each of the first log2(min(G, lpk))
// shuffle steps a lane keeps half of its rows and adds its partner's
// half, then plain butterflies finish.  Returns the first of the n rows
// this lane then holds in v[0 .. n) (all of the key's lanes that share
// the halving bits hold the same sums): about G shuffles, not G log2 lpk.
template <int G>
__device__ __forceinline__ int row_sums(float (&v)[G], int lpk, int piece,
                                        int& n) {
  int off = lpk / 2, base = 0;
  n = G;
  halve<G, G / 2>(v, piece, off, base, n);
  for (; off > 0; off /= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  return base;
}

template <typename T, typename Q, int G>
__global__ void __launch_bounds__(THREADS)
attend_kernel(const Q* __restrict__ q, const T* __restrict__ new_k,
              const T* __restrict__ new_v, T* kpool, T* vpool,
              const int* __restrict__ page_table,
              const int* __restrict__ seq_lens, float* __restrict__ out,
              float* __restrict__ pm, float* __restrict__ pl,
              float* __restrict__ pacc, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int slot_elems = 2 * KC * a.d;
  float* sc = reinterpret_cast<float*>(smem + STAGES * slot_elems *
                                                  sizeof(T));   // [KC][G]
  float* m_sm = sc + G * KC;
  float* l_sm = m_sm + G;
  float* alpha_sm = l_sm + G;

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lpk = a.lpk, ks_n = THREADS / lpk;  // lanes per key, key subsets
  const int piece = lane % lpk, kq = tid / lpk;
  const int d = a.d, group = a.group;
  const int ln = seq_lens[b];
  const int* pt = page_table + (int64_t)b * a.npm;
  const int64_t kh = (int64_t)h * a.head_mul + a.k_off;
  const int64_t vh = (int64_t)h * a.head_mul + a.v_off;
  const int64_t src = ((int64_t)b * a.hkv + h) * d;   // new_k / new_v row
  const int app_page = clampi(ln / a.ps, 0, a.npm - 1);
  const int app = app_page * a.ps + ln % a.ps;         // the appended position
  const int live = app_page + 1;                        // live pages
  const int ppc = KC / a.ps;                            // pages per chunk
  const int n_chunks = (live + ppc - 1) / ppc;
  const splitk::Span span = splitk::part(0, n_chunks, split, splits);
  const int c_end = span.first + span.count;
  const CopyLane cl = copy_lane(d, a.ps, 16 / (int)sizeof(T));

  if (split == splits - 1) {          // 1. append this step's K and V row
    const int page = clampi(pt[app_page], 0, a.n_phys - 1);
    const int64_t row = ((int64_t)page * a.ps + ln % a.ps) * a.heads;
    for (int c = tid; c < d; c += THREADS) {
      kpool[(row + kh) * d + c] = new_k[src + c];
      vpool[(row + vh) * d + c] = new_v[src + c];
    }
  }

  // 2. attend over chunks [span.first, c_end): the first STAGES - 1 in
  // flight, then the page ids of the next one to stage
  int id[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    const int c = span.first + i;
    if (c < c_end) {
      chunk_ids(pt, c, ppc, live, a.n_phys, lane, id);
      stage(ring + i * slot_elems, kpool, vpool, new_k + src, new_v + src,
            a, cl, c, ppc, min(ppc, live - c * ppc) * a.ps, app, kh, vh,
            id);
    }
    hop::cp_async_commit();
  }
  if (span.first + STAGES - 1 < c_end)
    chunk_ids(pt, span.first + STAGES - 1, ppc, live, a.n_phys, lane, id);

  constexpr int EPP = epp<T, G>();
  float qr[G][EPP], acc[G][EPP];
  const Q* qh = q + ((int64_t)b * a.hkv + h) * group * d;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPP; ++e) {
      const int c = piece * EPP + e;
      qr[g][e] = g < group && c < d ? widen(qh[g * d + c]) : 0.0f;
      acc[g][e] = 0.0f;
    }
  if (tid < G) {
    m_sm[tid] = NEG;
    l_sm[tid] = 0.0f;
    alpha_sm[tid] = 1.0f;
  }
  for (int i = tid; i < KC * G; i += THREADS) sc[i] = 0.0f;  // p of rows
                                      // past `group` stays 0
  const bool owns = piece * EPP < d;  // this lane's elements are in the row
  const int wmask = lpk > G ? lpk / G - 1 : 0;   // lanes that write scores

  for (int c = span.first; c < c_end; ++c) {
    const int s = (c - span.first) % STAGES;
    hop::cp_async_wait<STAGES - 2>();
    __syncthreads();                  // chunk c landed; the oldest slot and
                                      // the scores are free
    const int nxt = c + STAGES - 1;
    if (nxt < c_end) {
      stage(ring + (nxt - span.first) % STAGES * slot_elems, kpool, vpool,
            new_k + src, new_v + src, a, cl, nxt, ppc,
            min(ppc, live - nxt * ppc) * a.ps, app, kh, vh, id);
    }
    hop::cp_async_commit();
    if (nxt + 1 < c_end)
      chunk_ids(pt, nxt + 1, ppc, live, a.n_phys, lane, id);

    const T* kc = ring + s * slot_elems;
    const T* vc = kc + KC * d;
    const int keys = min(ppc, live - c * ppc) * a.ps;
    const int key0 = c * ppc * a.ps;
    // scores: key kq + ks_n * t, lanes over its head dim
    for (int j0 = 0; j0 < keys; j0 += ks_n) {
      const int j = j0 + kq;
      float kv[EPP] = {};
      if (j < keys && owns) load_n(kc + j * d + piece * EPP, kv);
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        dot[g] = 0.0f;
#pragma unroll
        for (int e = 0; e < EPP; ++e) dot[g] = fmaf(qr[g][e], kv[e], dot[g]);
      }
      int n;
      const int base = row_sums<G>(dot, lpk, piece, n);
      if ((piece & wmask) == 0 && j < keys) {
        const bool vis = key0 + j <= ln;
#pragma unroll
        for (int i = 0; i < G; ++i)
          if (i < n && base + i < group)
            sc[j * G + base + i] = vis ? dot[i] * a.scale : NEG;
      }
    }
    __syncthreads();                  // the chunk's scores are in
    // softmax: warp w owns rows w, w + 4, ...; lanes over the keys
    for (int g = warp; g < group; g += WARPS) {
      float s0 = lane < keys ? sc[lane * G + g] : NEG;
      float s1 = lane + 32 < keys ? sc[(lane + 32) * G + g] : NEG;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_sm[g];
      const float m_new = fmaxf(m_old, mx);
      s0 = lane < keys ? expf(s0 - m_new) : 0.0f;
      s1 = lane + 32 < keys ? expf(s1 - m_new) : 0.0f;
      float sum = s0 + s1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane < keys) sc[lane * G + g] = s0;
      if (lane + 32 < keys) sc[(lane + 32) * G + g] = s1;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_sm[g] = alpha;
        l_sm[g] = l_sm[g] * alpha + sum;
        m_sm[g] = m_new;
      }
    }
    __syncthreads();                  // p and alpha are in
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float alpha = alpha_sm[g];
#pragma unroll
      for (int e = 0; e < EPP; ++e) acc[g][e] *= alpha;
    }
    for (int j = kq; j < keys; j += ks_n) {
      if (!owns) break;
      float vv[EPP];
      load_n(vc + j * d + piece * EPP, vv);
#pragma unroll
      for (int g4 = 0; g4 < G; g4 += 4) {   // p of 4 rows per LDS.128
        const float4 p = *reinterpret_cast<const float4*>(sc + j * G + g4);
        const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < EPP; ++e)
            acc[g4 + r][e] = fmaf(pr[r], vv[e], acc[g4 + r][e]);
      }
    }
  }

  // 3. the key subsets' accumulators summed: within a warp by shuffles,
  // across warps through shared memory (the ring, now idle)
  hop::cp_async_wait<0>();
  __syncthreads();
  for (int off = lpk; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < EPP; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  float* red = reinterpret_cast<float*>(smem);        // [WARPS][G][d]
  if (lane < lpk && owns) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g < group)
#pragma unroll
        for (int e = 0; e < EPP; ++e)
          red[(warp * G + g) * d + piece * EPP + e] = acc[g][e];
  }
  __syncthreads();
  const int64_t rows = (int64_t)gridDim.y * a.hkv * group;
  const int64_t row0 = ((int64_t)b * a.hkv + h) * group;
  for (int e = tid; e < group * d; e += THREADS) {
    const int g = e / d, c = e % d;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[(w * G + g) * d + c];
    const int64_t row = row0 + g;
    if (splits == 1) {
      out[row * d + c] = sum / l_sm[g];   // the own token is live: l > 0
    } else {
      const int64_t p = (int64_t)split * rows + row;
      pacc[p * d + c] = sum;
      if (c == 0) {
        pm[p] = m_sm[g];
        pl[p] = l_sm[g];
      }
    }
  }
}

template <typename T, typename Q, int G>
int launch_g(const void* q, const void* new_k, const void* new_v, void* kpool,
             void* vpool, const int* page_table, const int* seq_lens,
             float* out, float* pm, float* pl, float* pacc, int batch,
             int splits, Args a, cudaStream_t stream) {
  a.lpk = 1;                          // lanes per key: LPK * EPP >= d
  while (a.lpk * epp<T, G>() < a.d) a.lpk *= 2;
  const int smem = smem_bytes<T, G>(a.d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attend_kernel<T, Q, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(a.hkv, batch, splits);
  attend_kernel<T, Q, G><<<grid, THREADS, smem, stream>>>(
      (const Q*)q, (const T*)new_k, (const T*)new_v, (T*)kpool, (T*)vpool,
      page_table, seq_lens, out, pm, pl, pacc, a);
  return (int)cudaGetLastError();
}

// Launch the attend kernel on `stream`; returns a CUDA error code,
// cudaErrorInvalidValue past the limits (d <= DMAX with rows of a multiple
// of 16 bytes, group <= GMAX, ps <= KC, batch <= BMAX, splits <= SMAX).
// splits > 1 writes the partials pm, pl (splits, rows) and pacc (splits,
// rows, d) for splitk::launch_combine; 1 writes out.
template <typename T, typename Q>
int launch(const void* q, const void* new_k, const void* new_v, void* kpool,
           void* vpool, const int* page_table, const int* seq_lens,
           float* out, float* pm, float* pl, float* pacc, int batch, int hkv,
           int group, int d, int ps, int npm, int n_phys, int heads,
           int head_mul, int k_off, int v_off, float scale, int splits,
           cudaStream_t stream) {
  if (d < 1 || d > DMAX || (d * (int)sizeof(T)) % 16 || group < 1 ||
      group > GMAX || ps < 1 || ps > KC || batch < 1 || batch > BMAX ||
      splits < 1 || splits > SMAX || npm < 1 || n_phys < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{hkv, group, d, ps, npm, n_phys, heads, head_mul, k_off,
               v_off, 0, scale};
  const auto run = group <= 4 ? &launch_g<T, Q, 4>
                   : group <= 8 ? &launch_g<T, Q, 8>
                                : &launch_g<T, Q, GMAX>;
  return run(q, new_k, new_v, kpool, vpool, page_table, seq_lens, out, pm,
             pl, pacc, batch, splits, a, stream);
}

}  // namespace pdec
