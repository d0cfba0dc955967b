"""Filter+reduce kernel (TPC-H Q6 shape): predicate, weighted sum.

The FlatMap(filter)+fold fusion of the paper: ``filter_reduce`` folds
each row's ``where(lo <= x < hi, x * w, 0)`` as it reads it, through the
CUDA kernel ``csrc/filter_fold.cuh`` for CUDA tensors and through its
plain PyTorch version, ``filter_reduce_plain``, for CPU tensors.  The
header's staged kernel serves ``fused_filter_fold``; both share the
launch below: one cooperative launch a call, the rows streamed through
a ``cp.async`` ring at the plan's depth (``ring_form`` lays it out) and
the blocks' partials added in block order inside the kernel
(``grid_flags``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import build
from .grid_flags import Flags
from ..device import place

SOURCE = '''// TPC-H Q6 filter-fold: filter_fold.cuh's kernels at depths 2 to 4
#include "filter_fold.cuh"

namespace {
// variant = 2 * depth + staged (filter_reduce.RingForm.variant)
const void* kernel_of(int variant) {
  using ffold::filter_fold_kernel;
  switch (variant) {
    case 4: return (const void*)filter_fold_kernel<false, 2>;
    case 5: return (const void*)filter_fold_kernel<true, 2>;
    case 6: return (const void*)filter_fold_kernel<false, 3>;
    case 7: return (const void*)filter_fold_kernel<true, 3>;
    case 8: return (const void*)filter_fold_kernel<false, 4>;
    case 9: return (const void*)filter_fold_kernel<true, 4>;
  }
  return nullptr;
}
}  // namespace

extern "C" int per_sm(int variant, int smem, int* n) {
  const void* k = kernel_of(variant);
  return k ? tcopy::blocks_per_sm(k, smem, n) : (int)cudaErrorInvalidValue;
}

extern "C" int filter_fold_launch(const void* x, const void* w, float lo,
                                  float hi, int block_t, int piece,
                                  int slot_words, long long steps,
                                  int variant, int ctas, int smem,
                                  void* flags, unsigned epoch, void* out,
                                  void* stream) {
  const void* k = kernel_of(variant);
  if (!k) return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &w, &lo, &hi, &block_t, &piece, &slot_words, &steps,
                  &flags, &epoch, &out};
  return gflags::launch(k, ctas, tcopy::THREADS, smem, (cudaStream_t)stream,
                        args);
}
'''

_VP, _INT = ctypes.c_void_p, ctypes.c_int
LIB = build.Library("filter_fold", SOURCE, {
    "per_sm": [_INT, _INT, ctypes.POINTER(_INT)],
    "filter_fold_launch": [_VP, _VP, ctypes.c_float, ctypes.c_float, _INT,
                           _INT, _INT, ctypes.c_longlong, _INT, _INT, _INT,
                           _VP, ctypes.c_uint, _VP, _VP]})
FLAGS = Flags()      # one word per block: its partial

DEPTHS = (2, 3, 4)   # the kernel's instantiations (dse.DEPTHS)
PIECE_ALIGN = 1024   # a piece is whole rounds of a float4 a thread (x 256)
COMBINE_WORDS = 1024  # block 0 gathers up to this many partials


@dataclasses.dataclass(frozen=True)
class RingForm:
    """A block's shared memory in a filter-fold call: the ring's unit (a
    whole step of ``block_t`` rows, or a ``piece`` of one) at ``depth``
    slots for x, w and, when ``staged``, the filter stage's output;
    ``slot_words`` floats a slot."""

    block_t: int
    depth: int
    staged: bool
    piece: int
    slot_words: int

    @property
    def arrays(self) -> int:
        return 3 if self.staged else 2

    @property
    def pieces(self) -> int:
        """Units a step takes."""
        return -(-self.block_t // self.piece)

    @property
    def ring_bytes(self) -> int:
        return 4 * self.arrays * self.depth * self.slot_words

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared bytes a block: the ring, at least block 0's
        gathered partials."""
        return max(self.ring_bytes, 4 * COMBINE_WORDS)

    @property
    def variant(self) -> int:
        """The library's kernel: 2 * depth + staged."""
        return 2 * self.depth + int(self.staged)


def slot_words(block_t: int, piece: int) -> int:
    """Floats a ring slot holds for units of ``piece`` rows: a unit that
    starts off a 16-byte boundary (``block_t`` not a multiple of 4) keeps
    the source's alignment, so up to 3 words more; rounded up to 16
    bytes."""
    return -(-(piece + (3 if block_t % 4 else 0)) // 4) * 4


def ring_form(block_t: int, depth: int, staged: bool, optin: int
              ) -> RingForm:
    """The ring of a filter-fold call at ``block_t`` rows a step and
    ``depth`` slots on a card whose blocks may use ``optin`` shared
    bytes: a whole step a slot where the ring fits, else the largest
    piece (a multiple of PIECE_ALIGN rows) that fits.  Raises
    ``ValueError`` for a depth the library has no kernel for, and, for
    the staged kernel, when a stage of ``block_t`` floats (the pipeline's
    intermediate, which the reference keeps in VMEM) does not fit a
    block's shared memory."""
    if depth not in DEPTHS:
        raise ValueError(f"ring depth {depth}: one of {DEPTHS}")
    if block_t < 1:
        raise ValueError(f"block_t {block_t} must be positive")
    if staged and 4 * block_t > optin:
        raise ValueError(
            f"a stage of block_t = {block_t} floats ({4 * block_t} B) does "
            f"not fit a block's shared memory ({optin} B)")
    arrays = 3 if staged else 2
    per_slot = optin // (4 * arrays * depth)
    if slot_words(block_t, block_t) <= per_slot:
        piece = block_t
    else:
        piece = (per_slot - 4) // PIECE_ALIGN * PIECE_ALIGN
        if piece < PIECE_ALIGN:
            raise ValueError(f"no ring of {depth} x {arrays} slots fits a "
                             f"block's shared memory ({optin} B)")
    return RingForm(block_t, depth, staged, piece, slot_words(block_t, piece))


def _auto_blocks(t: int, device) -> Tuple[int, int]:
    from .ops import resolve_plan
    bt, plan = resolve_plan("filter_reduce", t, device=device)
    return bt, plan.depth


def inputs(x, weight, lo, hi, block_t: int, device):
    """The checked inputs of a filter-fold: ``x`` and ``weight`` (any
    floating types) as (t,) float32 tensors on one device, the bounds
    rounded to float32 (as the reference rounds them), and ``block_t``
    clipped to t; raises unless block_t divides t."""
    x, weight = place((x, weight), device)
    if x.dim() != 1 or weight.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)}: two (t,) vectors")
    if not (x.is_floating_point() and weight.is_floating_point()):
        raise ValueError(f"x and weight must be floating point, got "
                         f"{x.dtype} and {weight.dtype}")
    # read as float32, as the reference's kernel reads them
    x, weight = x.float(), weight.float()
    lo, hi = float(np.float32(lo)), float(np.float32(hi))
    block_t = min(block_t, x.shape[0])
    if x.shape[0] % block_t:
        raise ValueError(f"block_t {block_t} must divide t = {x.shape[0]}")
    return x, weight, lo, hi, block_t


def filter_fold_plain(x: torch.Tensor, weight: torch.Tensor, lo: float,
                      hi: float) -> torch.Tensor:
    """Plain PyTorch version of both filter-fold kernels: the float32
    contributions ``where(lo <= x < hi, x * w, 0)`` of the whole input
    (bounds already float32 values), summed in float64 and returned as a
    float32 scalar."""
    contrib = torch.where((x >= lo) & (x < hi), x * weight, 0.0)
    return contrib.double().sum().float()


def launch(x: torch.Tensor, weight: torch.Tensor, lo: float, hi: float,
           block_t: int, staged: bool, depth: int = 2
           ) -> Tuple[torch.Tensor, int, RingForm]:
    """One cooperative launch of the filter-fold kernel (``staged`` keeps
    the filter stage's output in shared memory) at ``depth`` ring slots;
    its blocks' partials are added in block order inside it.  Returns
    ``(sum, blocks, ring form)``.  A view that starts off a 16-byte
    boundary is copied first (16-byte ``cp.async``).  Raises before any
    launch when the ring or a staged step does not fit a block's shared
    memory."""
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("the filter-fold kernels take contiguous inputs")
    dev = x.device
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    form = ring_form(block_t, depth, staged, optin)
    x, weight = build.aligned(x), build.aligned(weight)
    steps = x.shape[0] // block_t
    ctas = LIB.persistent_ctas(dev, form.variant, form.smem_bytes, steps)
    if ctas > COMBINE_WORDS:
        raise ValueError(f"{ctas} blocks: block 0 gathers at most "
                         f"{COMBINE_WORDS} partials")
    stream = torch.cuda.current_stream(dev).cuda_stream
    flags, epoch = FLAGS.next(dev, stream, ctas)
    out = torch.empty((), dtype=torch.float32, device=dev)
    LIB("filter_fold_launch", x.data_ptr(), weight.data_ptr(), lo, hi,
        block_t, form.piece, form.slot_words, steps, form.variant, ctas,
        form.smem_bytes, flags, epoch, out.data_ptr(), stream)
    return out, ctas, form


def filter_reduce_plain(x: torch.Tensor, weight: torch.Tensor, lo,
                        hi) -> torch.Tensor:
    """Plain PyTorch version of ``filter_reduce``."""
    x, weight, lo, hi, _ = inputs(x, weight, lo, hi, x.shape[0], None)
    return filter_fold_plain(x, weight, lo, hi)


def filter_reduce(x, weight, lo, hi, *, block_t: int = 1024,
                  auto_tile: bool = False, device=None) -> torch.Tensor:
    """``sum(where(lo <= x < hi, x * weight, 0))`` as a float32 scalar,
    the bounds rounded to float32 first.  x and weight are (t,) floating
    point, read as float32; ``block_t`` rows per grid step must divide t.
    ``auto_tile=True`` takes the DSE's block and ring depth for the fused
    filter+fold proxy (``dse.select_filter_reduce_blocks``) for the tier
    of the device the inputs are on; otherwise the ring has 2 slots.
    Replaces the TPU kernel ``filter_reduce`` (reference
    kernels/filter_reduce.py)."""
    depth = 2
    if auto_tile:
        x, weight = place((x, weight), device)
        block_t, depth = _auto_blocks(x.shape[0], x.device)
    x, weight, lo, hi, block_t = inputs(x, weight, lo, hi, block_t, device)
    if x.device.type == "cpu":
        return filter_fold_plain(x, weight, lo, hi)
    out, filter_reduce.ctas, filter_reduce.form = launch(
        x, weight, lo, hi, block_t, False, depth)
    filter_reduce.launches += 1
    return out


filter_reduce.launches = 0
filter_reduce.ctas = 0
filter_reduce.form = None
