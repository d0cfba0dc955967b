"""Mixtral-8x22B [arXiv:2401.04088]: 8 experts top-2, sliding window."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    fsdp=True,  # params exceed per-chip HBM at TP=16: ZeRO-3 shard
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384, vocab=32768,
    activation="swiglu", n_experts=8, top_k=2, moe_layer_period=1,
    sliding_window=4096)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=128, vocab=256, n_experts=4,
                     top_k=2, sliding_window=32, remat=False)
