"""Automated GEMM tile-size selection -- a thin front end over the
pattern-generic DSE (``core.dse``).

    "In future work, tile sizes for all pattern dimensions will instead
     be determined by the compiler through automated tile size selection
     using modeling and design space exploration."  (paper, §4)

The exploration (candidate enumeration, pricing, on-chip pruning,
argmin) lives in ``core.dse`` and serves every kernel's
``auto_tile=True`` path; this module adapts the GEMM plan to the
``TileChoice`` API.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.cost import Tier
from ..core.dse import MXU, SUBLANE, select_gemm_blocks  # noqa: F401

LANE = SUBLANE  # historical alias


@dataclasses.dataclass
class TileChoice:
    block_m: int
    block_n: int
    block_k: int
    traffic_words: int
    vmem_bytes: int


def select_gemm_tiles(m: int, n: int, k: int, *,
                      vmem_budget: Optional[int] = None,
                      tier: Optional[Tier] = None, device=None,
                      **tuning) -> TileChoice:
    """DSE over (bm, bn, bk): minimise the modelled main-memory traffic
    of the tiled IR within the on-chip budget (``dse.explore``) for
    ``tier``, else the tier of ``device`` (the card unless the caller
    names another device)."""
    (bm, bn, bk), plan = select_gemm_blocks(
        m, n, k, tier=tier, vmem_budget=vmem_budget, device=device,
        **tuning)
    return TileChoice(bm, bn, bk, plan.traffic_words, plan.vmem_bytes)


def tuned_matmul(x, y, **kw):
    """``matmul`` with the DSE's block sizes."""
    from .matmul import matmul

    return matmul(x, y, auto_tile=True, **kw)
