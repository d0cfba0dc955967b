// tiled_flatmap.cuh -- hand-written template of the tiled FlatMap kernel
// (the paper's parallel FIFO).
//
// Replaces the Pallas TPU kernel lower_tiled_flatmap (src/repro/core/
// codegen_pallas.py): FlatMap(grid) { tile loads; FlatMap(tile) }.  Each
// index emits up to M values and a count; the kept values of the whole
// domain come out compacted in grid order, then index order, then value
// order, in a buffer of n * M words whose tail past the total count is
// zero, plus the total count.
//
// The TPU kernel carries a running offset in scalar memory from one grid
// step to the next.  Blocks on the card run in no order, so the offset is
// a scan across blocks, done in three launches:
//
//  1. count_kernel: each warp of a block owns a contiguous segment of the
//     tile's indices and counts the values it keeps (seg_counts, one int
//     per (grid step, warp)).
//  2. scan_kernel: one block turns seg_counts into exclusive offsets in
//     grid-step-major, warp-minor order, and the total.
//  3. write_kernel: each block recomputes its tiles, each warp compacts its
//     segment in index order with a warp scan into the shared-memory FIFO
//     at its offset within the tile, and the block copies the FIFO out at
//     the tile's offset in one coalesced run.  The blocks then zero the
//     buffer's tail past the total.
//
// codegen_cuda.py instantiates the two tile kernels per FlatMap and plan,
// with the body spliced in and the loads' affine windows as constants
// (copy helpers from tile_copy.cuh).  Shared memory is what
// memory.plan_memory charges: each tile at DEPTH rotating slots plus the
// b * M word FIFO.
//
// What bounds it on the card: main-memory bytes (each input read twice by
// the two passes, the buffer written once).  The counts stay on the card:
// the host never reads them.
#pragma once

#include "tiled_map.cuh"

namespace tfm {

constexpr int WARPS = tcopy::THREADS / 32;
constexpr int SCAN_THREADS = 1024;

// A body's count clamped into [0, m] (values past m are never kept).
__device__ __forceinline__ int kept(int c, int m) {
  return c < 0 ? 0 : (c > m ? m : c);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// offsets[i] = sum of counts[0:i] for i in [0, n]; *total = offsets[n].
// One block of SCAN_THREADS threads walks the counts in chunks.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const int* __restrict__ counts, int* __restrict__ offsets,
            int* __restrict__ total, int64_t n) {
  __shared__ int warp_tot[SCAN_THREADS / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < n; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    const int v = i < n ? counts[i] : 0;
    const int x = warp_inclusive_scan(v);
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
      const int t = warp_inclusive_scan(
          lane < (int)(blockDim.x >> 5) ? warp_tot[lane] : 0);
      if (lane < (int)(blockDim.x >> 5)) warp_tot[lane] = t;
    }
    __syncthreads();
    const int incl = carry + x + (warp > 0 ? warp_tot[warp - 1] : 0);
    if (i < n) offsets[i] = incl - v;
    __syncthreads();  // every thread has read carry and warp_tot
    if (threadIdx.x == blockDim.x - 1) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    offsets[n] = carry;
    *total = carry;
  }
}

}  // namespace tfm
