// fused_kmeans.cuh -- hand-written megakernel of one k-means step: each
// point's nearest centroid, then the per-centroid sums of its points and
// their counts.
//
// Replaces the Pallas TPU kernel fused_kmeans_step / _km_kernel
// (src/repro/kernels/fused_kmeans.py): the assign -> {sum, count} DAG as
// one kernel with two outputs.
//
// What bounds it on the card: main-memory bytes in principle (4d read per
// point), but the k * d distance terms per point (a subtract, a multiply
// and an add each, no FMA) come close: at k = 8, d = 16 about 400
// instructions a point against 64 bytes, ~0.07 ms of issue for 4,194,304
// points on 132 SMs beside a 0.08 ms byte bound.  So the design spends no
// instruction it can avoid around them:
//
//  * The TPU grid revisits both outputs across its sequential steps.  Here
//    persistent blocks walk the BLOCK-point steps g = blockIdx.x,
//    + gridDim.x, ...; each block keeps its sums and counts in registers
//    across its steps, writes one partial of K * D + K words, and
//    fdag::combine_partials adds the partials in block order.
//  * Points stream through a DEPTH-slot ring of shared tiles filled by
//    cp.async DEPTH - 1 steps ahead, as fused_dag.cuh's metapipeline does
//    (one wait and one __syncthreads a step, which also frees the slot the
//    last step read).  Rows of a multiple of 16 bytes keep their stride
//    (no padding: 1024 rows x 64 B x 3 slots is 196,608 B, and a padded
//    ring would not fit 232,448 B) and are read back as whole 16-byte
//    chunks; chunk q of row r lies at q ^ swizzle(r), so that the 8 lanes
//    of a quarter-warp, reading 8 consecutive rows, hit 8 distinct 16-byte
//    bank groups (the rule below, by the row's chunk count C).  Other rows
//    are copied by 4-byte cp.async and read word by word.
//  * Each lane owns rows r, r + 256, ... of a step (warp w the rows
//    r % 256 in [32w, 32w + 32)), reads its row into registers once,
//    computes its nearest centroid and keeps both in its registers: no
//    assignment buffer and no barrier between stage and terminals.  The
//    centroids sit in shared memory (the Pipe-0 preload), read by
//    broadcast.
//  * The squared distance is summed over d in index order, one multiply
//    and one add per term, no fused multiply-add, as the port's kmeans
//    bodies and references sum it: the kernel, its plain version and the
//    reference agree bitwise on the assignment.  Ties go to the lowest
//    index, as argmin gives.
//  * The CAM adds by plain register adds in one fixed order (fused_dag.cuh's
//    CAM design, register form): the generated struct Cam holds the lane's
//    accumulators as named scalars (ptxas keeps an accumulator array in local
//    memory), the sums split as P column slots x 32 / P row groups (P = 1:
//    each lane adds its own row, no exchange; P > 1: rows pass to their owner
//    lanes through a per-warp staging), the counts at P = 1.  At the end a
//    fixed shuffle tree adds the row groups, the warps add into the block's
//    table in warp order, and the blocks are added in block order: two calls
//    are bitwise equal. kernels/fused_kmeans.py generates Cam and picks P
//    (kmeans_lanes).
#pragma once

#include "fused_dag.cuh"

namespace fkm {

constexpr int WARPS = tcopy::THREADS / 32;

constexpr int round4(int words) { return (words + 3) / 4 * 4; }

// The 16-byte chunk of row r that holds chunk q is q ^ swizzle<D>(r): with
// C = D / 4 chunks a row, rows r * C (mod 8) take 8 / gcd(C, 8) values, and
// the XOR spreads the 8 rows a quarter-warp reads over the rest
// (fused_kmeans.swizzle mirrors this rule).
template <int D>
__device__ __forceinline__ int swizzle(int r) {
  constexpr int C = D / 4;
  if constexpr (D % 4 != 0 || C % 2 == 1) return 0;
  else if constexpr (C % 4 == 2) return (r >> 2) & 1;
  else if constexpr (C % 8 == 4) return (r >> 1) & 3;
  else return r & 7;
}

// Shared memory, in words, each part 16-byte aligned: the ring
// (DEPTH x BLOCK x D), the centroids (K x D), the block table (K x D sums,
// then K counts) and the warps' CAM staging (fused_kmeans.layout).
template <int K, int D, int BLOCK, int DEPTH, int STAGE_WORDS>
struct Layout {
  static constexpr int SLOT = BLOCK * D;
  static constexpr int CENTS = round4(DEPTH * SLOT);
  static constexpr int TABLE = CENTS + round4(K * D);
  static constexpr int STAGE = TABLE + round4(K * D + K);
  static constexpr int BYTES = 4 * (STAGE + WARPS * STAGE_WORDS);
};

// Issue the copies of one step's BLOCK x D tile into a ring slot; the
// caller commits the group.
template <int D, int BLOCK>
__device__ __forceinline__ void fill(float* __restrict__ slot,
                                     const float* __restrict__ src) {
  if constexpr (D % 4 == 0) {
    constexpr int C = D / 4;
    for (int e = threadIdx.x; e < BLOCK * C; e += blockDim.x) {
      const int r = e / C, q = e - r * C;
      hop::cp_async<16>(slot + 4 * (r * C + (q ^ swizzle<D>(r))),
                        src + 4 * e, 16);
    }
  } else {
    for (int e = threadIdx.x; e < BLOCK * D; e += blockDim.x)
      hop::cp_async<4>(slot + e, src + e, 4);
  }
}

// Row r of a ring slot into registers.
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ tile,
                                         int r, float (&x)[D]) {
  if constexpr (D % 4 == 0) {
    const float4* const row =
        reinterpret_cast<const float4*>(tile) + r * (D / 4);
    const int s = swizzle<D>(r);
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
      const float4 f = row[q ^ s];
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int a = 0; a < D; ++a) x[a] = tile[r * D + a];
  }
}

// The nearest of the K centroids to x: the squared distance summed over d
// in index order without FMA, the first minimum.
template <int K, int D>
__device__ __forceinline__ int nearest(const float* __restrict__ cents,
                                       const float (&x)[D]) {
  float best = INFINITY;
  int arg = 0;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    float s = 0.0f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const float t = cents[c * D + a] - x[a];
      s = __fadd_rn(s, __fmul_rn(t, t));
    }
    if (s < best) {  // first minimum
      best = s;
      arg = c;
    }
  }
  return arg;
}

// Cam: the generated accumulators (kernels/fused_kmeans.py):
//   static constexpr int STAGE_WORDS;     // a warp's staging, 0 for P = 1
//   void add(const float (&v)[D], int key, int lane, float* stage_w);
//   void finish(float* sums, float* counts, int warp, int lane);
// add takes every lane of the warp (rows past BLOCK with key -1); finish
// adds the row groups and then, in warp order, the warps into the block's
// table, a __syncthreads before each warp's turn.
template <int K, int D, int BLOCK, int DEPTH, class Cam>
__global__ void __launch_bounds__(tcopy::THREADS, 1)
kmeans_kernel(const float* __restrict__ points,
              const float* __restrict__ cents, long long steps,
              float* __restrict__ partials) {
  static_assert(DEPTH >= 2, "the ring needs two slots");
  using L = Layout<K, D, BLOCK, DEPTH, Cam::STAGE_WORDS>;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* const c_s = smem + L::CENTS;
  float* const table = smem + L::TABLE;
  float* const stage_w = smem + L::STAGE + warp * Cam::STAGE_WORDS;

  tcopy::copy_scalar(c_s, cents, K * D);
  fdag::zero(table, K * D + K);
  // the ring: the first DEPTH - 1 steps in flight
#pragma unroll
  for (int s = 0; s < DEPTH - 1; ++s) {
    const long long gs = blockIdx.x + (long long)s * gridDim.x;
    if (gs < steps) fill<D, BLOCK>(smem + s * L::SLOT, points + gs * L::SLOT);
    hop::cp_async_commit();
  }
  Cam cam;
  int step = 0;
  for (long long g = blockIdx.x; g < steps; g += gridDim.x, ++step) {
    hop::cp_async_wait<DEPTH - 2>();  // this thread's copies of step
    __syncthreads();  // everyone's landed; step - 1's slot is free
    const long long ga = g + (long long)(DEPTH - 1) * gridDim.x;
    if (ga < steps)
      fill<D, BLOCK>(smem + ((step + DEPTH - 1) % DEPTH) * L::SLOT,
                     points + ga * L::SLOT);
    hop::cp_async_commit();
    const float* const tile = smem + (step % DEPTH) * L::SLOT;
    for (int r0 = warp * 32; r0 < BLOCK; r0 += tcopy::THREADS) {
      const int r = r0 + lane;
      float x[D];
      int key = -1;
      if (r < BLOCK) {
        load_row<D>(tile, r, x);
        key = nearest<K, D>(c_s, x);
      } else {
#pragma unroll
        for (int a = 0; a < D; ++a) x[a] = 0.0f;
      }
      cam.add(x, key, lane, stage_w);
    }
  }
  hop::cp_async_wait<0>();
  cam.finish(table, table + K * D, warp, lane);
  __syncthreads();
  float* const part = partials + (long long)blockIdx.x * (K * D + K);
  for (int e = threadIdx.x; e < K * D + K; e += blockDim.x) part[e] = table[e];
}

}  // namespace fkm
