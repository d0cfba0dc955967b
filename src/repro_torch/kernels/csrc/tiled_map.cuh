// tiled_map.cuh -- hand-written template of the write-once tiled Map kernel.
//
// Replaces the Pallas TPU kernel lower_tiled_map (src/repro/core/
// codegen_pallas.py): MultiFold(grid) write-once { tile loads; Map(tile) },
// the pattern body applied across each tile and one output block written
// per grid step.  No output is revisited, so there is no hazard between
// blocks.
//
// codegen_cuda.py instantiates this template once per tiled Map and plan:
// it writes the Map's body as a __device__ function and the kernel's main
// loop, with the plan's constants (grid, tile domain, depth) and each
// load's affine window (flat source offset = origin + sum_j step_j * g_j)
// emitted as constants.  Grids and tiles may be N-D.
//
// What bounds it on the card: main-memory bytes.  A Map body does a few
// operations per output word (one multiply for the outer product), so the
// output stream sets the time.  The design:
//
//  * Persistent blocks (a few per SM, as occupancy allows) walk the grid
//    steps g = blockIdx.x, blockIdx.x + gridDim.x, ...; each step copies its
//    tiles into DEPTH rotating shared-memory slots (slot = step % DEPTH), the
//    bytes memory.plan_memory charges, and loop-invariant (hoisted) tiles
//    once per block.  The copies are synchronous in this first version.
//  * The threads walk the tile's domain in row-major order, so neighbouring
//    threads write neighbouring output words; each index's elem_shape words
//    go straight to device memory (the plan charges nothing for them).
#pragma once

#include "tile_copy.cuh"

namespace tmap {

// A window start clamped into [0, hi], as dynamic_slice clamps it.
__device__ __forceinline__ int clamp_start(int x, int hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

}  // namespace tmap
