"""Assigned input-shape set (applies to every architecture).

``train_*`` lowers train_step; ``prefill_*`` lowers a forward pass;
``decode_*`` / ``long_*`` lower serve_step (one new token against a KV
cache of ``seq_len``).  ``long_500k`` requires sub-quadratic attention:
it runs for SSM / hybrid / sliding-window archs and is skipped (with a
note) for pure full-attention archs -- see DESIGN.md §5.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def sub_quadratic(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid") or cfg.sliding_window is not None


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not sub_quadratic(cfg):
        return ("full-attention arch: 512k dense-KV decode is "
                "quadratic/unbounded -- skipped per DESIGN.md §5")
    return None
