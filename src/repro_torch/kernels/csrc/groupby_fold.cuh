// groupby_fold.cuh -- hand-written kernel of the dense keyed sum:
// out[key] += values[i] over the rows i with key = keys[i] in [0, K).
//
// Replaces the Pallas TPU kernel groupby_fold / _gbf_kernel
// (src/repro/kernels/groupby_fold.py), which pushes each tile's one-hot
// key matrix through the MXU into a revisited (K, E) output block.
//
// What bounds it on the card: main-memory bytes (4 + 4E read per row)
// if the adds stay cheap.  The TPU grid revisits its (K, E) output across
// the sequential grid; here persistent blocks walk the BLOCK-row steps
// g = blockIdx.x, + gridDim.x, ..., each keeps its own tables across its
// steps and writes one partial of K x E words, and
// fdag::combine_partials adds the partials in block order.  In either form
// every cell has one owner lane, which adds into it with a plain add, and
// one summation order runs from row to output, so two calls are bitwise
// equal.  Rows stream straight from global memory, coalesced, each warp
// issuing a whole batch of loads before its adds; the plan's depth has no
// slots to fill here.  Keys outside [0, K) are dropped, as jax.nn.one_hot
// drops them.  groupby_fold.table_form picks the form:
//
//  * Register form (register_kernel; the router's 8 x 1): fused_dag.cuh's CAM
//    at P = 1.  Each lane owns rows r, r + 256, ... of a step (warp w the
//    rows r % 256 in [32w, 32w + 32)) and adds each into K x E named
//    accumulators (the generated struct Cam), no exchange.  At the end a
//    fixed shuffle tree adds the lanes, then the warps add into the block's
//    table in warp order.  A row costs K compares and K x E predicated adds,
//    about K (E + 1) lane instructions against its 4 (1 + E) bytes; the card
//    issues about 10 lane instructions per byte it reads (132 SMs x 4
//    schedulers x 32 lanes x 1.98 GHz over 3.35 TB/s), so the form stays on
//    its bytes while K <= 40, and a lane's registers hold K x E <= 64
//    accumulators.
//  * Shared form (shared_kernel; 64 keys x 8 values), for the rest.  The
//    register form at 64 x 8 would hold 512 words a lane: fused_dag's
//    cam_forms would take P = 8 (64 words, 8 warps x 1,152 B of staging),
//    64 compare-and-adds per staged value, about 32 warp instructions a
//    row, or 4,194,304 rows / (132 SMs x 4 schedulers x 1.98 GHz) = 0.13
//    ms of issue against a 0.045 ms byte bound.  One table per warp in
//    shared memory would need 8 x 2,048 B beside the rows, and a warp's
//    lanes would still collide on a key.  So each warp splits into R row
//    groups of 32 / R lanes, and every (warp, group) owns a table in
//    shared memory: lane c of a group owns columns c, c + 32 / R, ... of
//    its group's table and adds its row's value into table[key][c], one
//    read-modify-write per value and no compare chain.  E = 8 gives R = 4
//    groups a warp; 32 tables x 2,048 B = 64 KB (three blocks per SM).
//    Tables are 32 / R words apart beyond a multiple of 32 (8 words at E
//    = 8), so the groups' rows of one key start in different banks.  A
//    chunk of 32 rows is read as one coalesced run: lane c of group g gets
//    rows g, g + R, ... of the chunk at its columns, and keys come by
//    shuffle.  At the end each thread adds one cell over the tables, row
//    groups first and then warps, in order.
#pragma once

#include "fused_dag.cuh"

namespace gbf {

constexpr int WARPS = tcopy::THREADS / 32;

// Cam: the generated register accumulators (kernels/groupby_fold.py):
//   void add(const float (&v)[E], int key, int lane, float* stage_w);
//   void finish(float* table, int warp, int lane);
// finish adds the lanes by a shuffle tree and then, in warp order, the
// warps into the block's table, a __syncthreads before each warp's turn.
template <int K, int E, int BLOCK, class Cam>
__global__ void __launch_bounds__(tcopy::THREADS)
register_kernel(const int* __restrict__ keys,
                const float* __restrict__ values, long long steps,
                float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  float* const table = reinterpret_cast<float*>(smem4);  // [K][E]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  fdag::zero(table, K * E);
  Cam cam;
  for (long long g = blockIdx.x; g < steps; g += gridDim.x) {
    const long long row0 = g * BLOCK;
#pragma unroll 8
    for (int r = threadIdx.x; r < BLOCK; r += tcopy::THREADS) {
      const int key = keys[row0 + r];
      float v[E];
#pragma unroll
      for (int c = 0; c < E; ++c) v[c] = values[(row0 + r) * E + c];
      cam.add(v, key, lane, nullptr);
    }
  }
  cam.finish(table, warp, lane);
  __syncthreads();
  float* const part = partials + (long long)blockIdx.x * (K * E);
  for (int e = threadIdx.x; e < K * E; e += blockDim.x) part[e] = table[e];
}

// The shared form's tables: R row groups a warp of LANES = 32 / R lanes,
// each lane COLS columns; a (warp, group) table is STRIDE words
// (groupby_fold.shared_bytes).
template <int K, int E, int R>
struct Shared {
  static constexpr int LANES = 32 / R;
  static constexpr int COLS = (E + LANES - 1) / LANES;
  static constexpr int STRIDE = (K * E + 31) / 32 * 32 + (R > 1 ? LANES : 0);
  static constexpr int BYTES = 4 * WARPS * R * STRIDE;
  // rows of a chunk a group loads (one column each) before it adds them
  static constexpr int BATCH = LANES < 16 ? LANES : 16;
};

template <int K, int E, int BLOCK, int R>
__global__ void __launch_bounds__(tcopy::THREADS)
shared_kernel(const int* __restrict__ keys, const float* __restrict__ values,
              long long steps, float* __restrict__ partials) {
  using S = Shared<K, E, R>;
  extern __shared__ float4 smem4[];
  float* const tables = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / S::LANES, col = lane % S::LANES;
  float* const mine = tables + (warp * R + grp) * S::STRIDE;
  fdag::zero(tables, WARPS * R * S::STRIDE);
  __syncthreads();
  for (long long g = blockIdx.x; g < steps; g += gridDim.x) {
    for (int r0 = warp * 32; r0 < BLOCK; r0 += tcopy::THREADS) {
      // a chunk of 32 rows: row r0 + grp + R * m is group grp's m-th
      const long long base = g * BLOCK + r0;
      const int kl = r0 + lane < BLOCK ? keys[base + lane] : -1;
#pragma unroll
      for (int q = 0; q < S::COLS; ++q) {
        const int c = col + S::LANES * q;
#pragma unroll
        for (int m0 = 0; m0 < S::LANES; m0 += S::BATCH) {
          float x[S::BATCH];
#pragma unroll
          for (int b = 0; b < S::BATCH; ++b) {
            const int r = grp + R * (m0 + b);
            x[b] = (r0 + r < BLOCK && c < E) ? values[(base + r) * E + c]
                                             : 0.0f;
          }
#pragma unroll
          for (int b = 0; b < S::BATCH; ++b) {
            const int key = __shfl_sync(0xffffffffu, kl, grp + R * (m0 + b));
            if ((unsigned)key < (unsigned)K && c < E)
              mine[key * E + c] += x[b];
          }
        }
      }
    }
  }
  __syncthreads();
  float* const part = partials + (long long)blockIdx.x * (K * E);
  for (int e = threadIdx.x; e < K * E; e += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      float ws = 0.0f;
#pragma unroll
      for (int q = 0; q < R; ++q) ws += tables[(w * R + q) * S::STRIDE + e];
      s += ws;
    }
    part[e] = s;
  }
}

}  // namespace gbf
