"""Architecture registry: --arch <id> resolves here."""
from . import (granite3_2b, internvl2_1b, llama4_maverick, mamba2_370m,
               mixtral_8x22b, musicgen_medium, nemotron4_15b, qwen2_72b,
               starcoder2_15b, zamba2_2_7b)
from .shapes import SHAPES, ShapeConfig, skip_reason, sub_quadratic

ARCHS = {
    "starcoder2-15b": starcoder2_15b,
    "nemotron-4-15b": nemotron4_15b,
    "granite-3-2b": granite3_2b,
    "qwen2-72b": qwen2_72b,
    "mamba2-370m": mamba2_370m,
    "musicgen-medium": musicgen_medium,
    "zamba2-2.7b": zamba2_2_7b,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "mixtral-8x22b": mixtral_8x22b,
    "internvl2-1b": internvl2_1b,
}


def get_config(arch: str, smoke: bool = False):
    mod = ARCHS[arch]
    return mod.SMOKE if smoke else mod.CONFIG
