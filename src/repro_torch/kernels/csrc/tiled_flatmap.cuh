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
// a scan across tiles, done in the same launch as the compaction by
// decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA, 2016).  One pass over x, and
// one run of the body per index:
//
//  * Persistent blocks walk the tiles in grid order, g = blockIdx.x,
//    + gridDim.x, ...; the tiles arrive through fused_dag.cuh's cp.async
//    ring at the plan's DEPTH slots, DEPTH - 1 tiles ahead (loads that are
//    not 16-byte copyable are copied synchronously into their slot).
//  * Within a tile each warp owns a contiguous segment of SEG indices and
//    the same SEG * M words of the shared FIFO.  (1) The warp runs the body
//    over its segment on the staged tile, UNROLL chunks of 32 indices at a
//    time (their loads in flight together), and compacts what it keeps at
//    the front of its FIFO region in index order (a ballot for M == 1, a
//    warp scan else).  (2) The block adds the warp counts in warp order:
//    each warp's offset within the tile and the tile's count.  (3) After
//    the look-back each warp copies its region out at the tile's offset
//    plus its own, coalesced.  Only warp w touches FIFO region w, so the
//    FIFO needs no barrier of its own.
//  * Tile g publishes its count as an AGGREGATE grid_flags word as soon as
//    the block knows it (tile 0 its INCLUSIVE prefix).  Then the whole
//    block looks back (look_back): thread t waits for the word of tile
//    g - 1 - t, and the words up to the nearest INCLUSIVE one are added
//    (the next 256 tiles if none is); tile g's INCLUSIVE word follows.
//    256 predecessors cover more than a round of the grid, so one round
//    trip to L2 nearly always ends the walk.  A tile waits only on lower
//    tiles, each of which publishes its aggregate before it waits itself,
//    and the grid is co-resident (a cooperative launch), so every wait
//    ends.
//  * After its last tile every block acquires tile GRID - 1's INCLUSIVE
//    word (the total), the block of tile GRID - 1 writes the count, and
//    each block zeroes its share of the buffer past the total.
//
// The body runs on every index of a chunk, also past the segment's end:
// each read window is clamped into its tile, and what such an index keeps
// is dropped.
//
// codegen_cuda.py instantiates the tile kernel per FlatMap and plan, with
// the body spliced in and the loads' affine windows as constants.  Dynamic
// shared memory is what memory.plan_memory charges -- each tile at DEPTH
// rotating slots plus the b * M word FIFO -- and, after it, the scan's
// scratch (Scan, SCAN_BYTES; counted apart: TiledSpec.scan_bytes).  No
// atomics: every flag word has one writer.
//
// What bounds it on the card: main-memory bytes (x read once, the buffer
// written once).  The counts stay on the card: the host never reads them.
#pragma once

#include <limits.h>

#include "fused_dag.cuh"
#include "grid_flags.cuh"
#include "tiled_map.cuh"

namespace tfm {

constexpr int WARPS = tcopy::THREADS / 32;
constexpr int UNROLL = 4;  // chunks of 32 indices a warp runs at once
constexpr unsigned FULL = 0xffffffffu;

// The scan's scratch in shared memory, after the charged buffers.
struct Scan {
  int warp_count[WARPS];  // this tile's count of each warp
  int first[WARPS];       // look-back: each warp's nearest INCLUSIVE thread
  int part[WARPS];        // look-back: each warp's sum of words
  int total;              // the count of the whole domain
  int pad[3];
};
constexpr int SCAN_BYTES = (int)sizeof(Scan);
static_assert(SCAN_BYTES % 16 == 0, "Scan keeps 16-byte alignment");

// A body's count clamped into [0, m] (values past m are never kept).
__device__ __forceinline__ int kept(int c, int m) {
  return c < 0 ? 0 : (c > m ? m : c);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Where this lane's c kept values go in its warp's run of the FIFO for
// one chunk of 32 indices; `run` advances past the chunk.
template <int M>
__device__ __forceinline__ int place(int c, int& run) {
  if constexpr (M == 1) {
    const unsigned lane = threadIdx.x & 31;
    const unsigned keeps = __ballot_sync(FULL, c > 0);
    const int at = run + __popc(keeps & ((1u << lane) - 1u));
    run += __popc(keeps);
    return at;
  } else {
    const int incl = warp_inclusive_scan(c);
    const int at = run + incl - c;
    run += __shfl_sync(FULL, incl, 31);
    return at;
  }
}

// Publish tile g's count: tile 0's is its INCLUSIVE prefix, the others'
// an AGGREGATE until look_back knows their prefix.  One thread.
__device__ __forceinline__ void publish_count(uint64_t* flags, long long g,
                                              int count, unsigned epoch) {
  gflags::publish(flags + g,
                  gflags::word(epoch,
                               g == 0 ? gflags::INCLUSIVE : gflags::AGGREGATE,
                               (uint32_t)count));
}

// Tile g's exclusive prefix, by the whole block: in each round thread t
// waits for the word of tile top - t (top = g - 1, then blockDim.x lower
// each round; before tile 0 a prefix of 0); the words up to the nearest
// INCLUSIVE one are added and end the walk.  Every thread returns the
// prefix; thread 0 publishes tile g's INCLUSIVE word.
__device__ __forceinline__ int look_back(uint64_t* flags, long long g,
                                         int count, unsigned epoch,
                                         Scan* scan) {
  if (g == 0) return 0;  // published INCLUSIVE by publish_count
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int excl = 0;
  for (long long top = g - 1;; top -= blockDim.x) {
    const long long j = top - threadIdx.x;
    uint32_t state = gflags::INCLUSIVE, v = 0;
    if (j >= 0) {
      const uint64_t w = gflags::wait(flags + j, epoch, gflags::ANY);
      state = gflags::state_of(w, epoch);
      v = gflags::value_of(w);
    }
    const unsigned inc = __ballot_sync(FULL, state == gflags::INCLUSIVE);
    if (lane == 0) scan->first[warp] = inc ? 32 * warp + __ffs(inc) - 1
                                           : INT_MAX;
    __syncthreads();
    int stop = INT_MAX;
    for (int w = 0; w < WARPS; ++w) stop = min(stop, scan->first[w]);
    const int part = warp_sum((int)threadIdx.x <= stop ? (int)v : 0);
    if (lane == 0) scan->part[warp] = part;
    __syncthreads();
    for (int w = 0; w < WARPS; ++w) excl += scan->part[w];
    if (stop != INT_MAX) break;
    __syncthreads();  // first and part are read before the next round
  }
  if (threadIdx.x == 0)
    gflags::publish(flags + g, gflags::word(epoch, gflags::INCLUSIVE,
                                            (uint32_t)(excl + count)));
  return excl;
}

// After a block's last tile: the total from tile GRID - 1's INCLUSIVE
// word; the block of that tile writes the count; every block zeroes its
// share of buf[total, cap), 16 bytes a store where it can.
__device__ __forceinline__ void tail(float* __restrict__ buf,
                                     int* __restrict__ count,
                                     const uint64_t* flags, long long grid,
                                     long long cap, unsigned epoch,
                                     Scan* scan) {
  if (threadIdx.x == 0) {
    const uint64_t w =
        gflags::wait(flags + grid - 1, epoch, 1u << gflags::INCLUSIVE);
    scan->total = (int)gflags::value_of(w);
    if (blockIdx.x == (grid - 1) % gridDim.x) *count = scan->total;
  }
  __syncthreads();
  const long long total = scan->total;
  const long long lo4 = (total + 3) / 4, hi4 = cap / 4;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (lo4 >= hi4) {
    for (long long e = total + t; e < cap; e += stride) buf[e] = 0.0f;
    return;
  }
  for (long long e = total + t; e < 4 * lo4; e += stride) buf[e] = 0.0f;
  float4* const b4 = reinterpret_cast<float4*>(buf);
  for (long long e = lo4 + t; e < hi4; e += stride)
    b4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long e = 4 * hi4 + t; e < cap; e += stride) buf[e] = 0.0f;
}

}  // namespace tfm
